"""The job-spec reader — the port's stand-in for ``yaml.safe_load`` (the
JAX `launch.job` imports PyYAML, which the card's machine does not have;
the port never imports ``yaml``, on any machine).

It reads the YAML subset that job specs use, and refuses the rest:

* block mappings and block sequences (``- item``, ``- key: value``),
  nested by indentation (spaces only);
* flow sequences and flow mappings on one line (``knobs: [A, B]``,
  ``h0: {slots: 1}``);
* plain, single-quoted and double-quoted scalars (of the backslash
  escapes only ``\\\\`` and ``\\"``), resolved as PyYAML's
  ``safe_load`` resolves them (YAML 1.1): ``null``/``~``/empty to None,
  ``true``/``yes``/``on`` (and their capitalised forms) to True,
  ``false``/``no``/``off`` to False, decimal integers to int, PyYAML's
  float forms (``1.5``, ``1.0e+3``, ``.inf``, ``.nan``) to float;
* ``#`` comments.

Anything else — anchors, aliases, tags, block scalars (``|``, ``>``),
every other backslash escape, multi-line scalars, several documents,
duplicate keys, tab characters, and the scalars PyYAML would turn into something a spec never means
(octal, hexadecimal, binary or sexagesimal numbers, underscores in
numbers, dates, merge keys) — raises `ValueError` naming the line. It
never guesses.
"""

from __future__ import annotations

import re

__all__ = ["load", "loads"]

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9]*\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# Forms PyYAML resolves to values a job spec never means; refused.
_REFUSED = (
    (re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"),
     "a binary, octal or hexadecimal number"),
    (re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"),
     "a sexagesimal number"),
    (re.compile(r"[-+]?\.?[0-9][0-9_.]*(?:[eE][-+][0-9]+)?"),
     "a number with underscores"),
    (re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?"), "a date"),
    (re.compile(r"<<|="), "a merge or value key"),
)


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _fail(no: int, msg: str):
    raise ValueError(f"line {no}: {msg}")


def _resolve(text: str, no: int):
    """A plain scalar's value, as ``safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF.fullmatch(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.fullmatch(text):
        return float("nan")
    for pattern, what in _REFUSED:
        if pattern.fullmatch(text) and (what != "a number with underscores"
                                        or "_" in text):
            _fail(no, f"{text!r} reads as {what} in YAML; quote it")
    if text[0] in "&*!|>%@`":
        _fail(no, f"{text!r}: anchors, aliases, tags, block scalars and "
                  "directives are not supported")
    if text.startswith(("- ", "? ")) or text in ("-", "?"):
        _fail(no, f"unexpected {text!r}")
    return text


def _double_quoted(s: str, i: int, no: int) -> tuple[str, int]:
    """The double-quoted scalar opening at ``s[i]``; returns (value, index
    past the closing quote)."""
    out, i = [], i + 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= len(s):
                _fail(no, "multi-line double-quoted scalars are not supported")
            e = s[i + 1]
            if e not in ('"', "\\"):
                _fail(no, f"the escape \\{e} is not supported (only \\\\ "
                          'and \\")')
            out.append(e)
            i += 2
        else:
            out.append(c)
            i += 1
    _fail(no, "multi-line double-quoted scalars are not supported")


def _single_quoted(s: str, i: int, no: int) -> tuple[str, int]:
    out, i = [], i + 1
    while i < len(s):
        if s[i] == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(s[i])
        i += 1
    _fail(no, "multi-line single-quoted scalars are not supported")


def _quoted(s: str, i: int, no: int) -> tuple[str, int]:
    return (_double_quoted if s[i] == '"' else _single_quoted)(s, i, no)


def _rest_is_comment(s: str, i: int, no: int) -> None:
    rest = s[i:]
    if rest.strip() and not re.match(r"\s+#", rest) and not (
            rest.startswith("#") and i == 0):
        _fail(no, f"unexpected text after a scalar: {rest.strip()!r}")


def _strip_comment(s: str) -> str:
    """A plain scalar's text: up to a `` #`` comment, trailing blanks
    dropped."""
    m = re.search(r"\s#", s)
    return (s[:m.start()] if m else s).rstrip()


class _Flow:
    """One-line flow collection parser (``[...]``, ``{...}``)."""

    def __init__(self, s: str, no: int):
        self.s, self.no, self.i = s, no, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self):
        self._ws()
        if self.i >= len(self.s):
            _fail(self.no, "flow collections must close on their line")
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "\"'":
            value, self.i = _quoted(self.s, self.i, self.no)
            return value
        m = re.compile(r"[^,\[\]{}#]*").match(self.s, self.i)
        text = m.group().rstrip()
        if ": " in text or text.endswith(":"):
            _fail(self.no, "single-pair flow mappings inside a flow "
                           "sequence are not supported")
        self.i = m.start() + len(m.group())
        return _resolve(text, self.no)

    def _key(self):
        self._ws()
        if self.i < len(self.s) and self.s[self.i] in "\"'":
            key, self.i = _quoted(self.s, self.i, self.no)
        else:
            m = re.compile(r"[^,\[\]{}:#]*").match(self.s, self.i)
            self.i = m.end()
            key = _resolve(m.group().strip(), self.no)
        self._ws()
        if self.s[self.i:self.i + 1] != ":":
            _fail(self.no, "a flow mapping entry needs `key: value`")
        self.i += 1
        return key

    def _items(self, close: str, item):
        self.i += 1
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == close:
                self.i += 1
                return
            item()
            self._ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != close:
                _fail(self.no, f"expected ',' or {close!r} in a flow "
                               "collection")

    def _seq(self):
        out: list = []
        self._items("]", lambda: out.append(self.node()))
        return out

    def _map(self):
        out: dict = {}

        def entry():
            key = self._key()
            if key in out:
                _fail(self.no, f"duplicate key {key!r}")
            out[key] = self.node()

        self._items("}", entry)
        return out


def _inline_value(text: str, no: int):
    """The value written after ``key:`` or ``-`` on the same line."""
    if text[0] in "[{":
        flow = _Flow(text, no)
        value = flow.node()
        _rest_is_comment(text, flow.i, no)
        return value
    if text[0] in "\"'":
        value, end = _quoted(text, 0, no)
        _rest_is_comment(text, end, no)
        return value
    plain = _strip_comment(text)
    if ": " in plain or plain.endswith(":"):
        _fail(no, f"{plain!r}: a nested mapping must start on its own line")
    return _resolve(plain, no)


def _split_key(line: _Line):
    """``(key, rest)`` of a ``key: value`` / ``key:`` line, else None."""
    s = line.text
    if s[0] in "\"'":
        key, end = _quoted(s, 0, line.no)
        rest = s[end:]
        if not (rest.startswith(": ") or rest.rstrip() == ":"
                or re.match(r":\s+#", rest)):
            return None
        return key, rest[1:].strip()
    m = re.search(r":(?:\s|$)", s)
    if m is None or (s.find(" #") != -1 and s.find(" #") < m.start()):
        return None
    key_text = s[:m.start()].rstrip()
    if not key_text or key_text[0] in "[{&*!|>%@`?-" and key_text != "-":
        _fail(line.no, f"unsupported mapping key {key_text!r}")
    return _resolve(key_text, line.no), s[m.end():].strip()


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines, self.i = lines, 0

    def _peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int):
        line = self._peek()
        if line.text == "-" or line.text.startswith("- "):
            return self._seq(indent)
        if _split_key(line) is not None:
            return self._map(indent)
        self.i += 1
        value = _inline_value(line.text, line.no)
        nxt = self._peek()
        if nxt is not None and nxt.indent >= indent:
            _fail(nxt.no, "multi-line scalars are not supported")
        return value

    def _child(self, parent: _Line, rest: str, indent: int):
        """The value of ``key:`` / ``-`` whose inline text is ``rest``."""
        nxt = self._peek()
        if rest:
            if nxt is not None and nxt.indent > indent:
                _fail(nxt.no, "unexpected indentation (multi-line scalars "
                              "are not supported)")
            return _inline_value(rest, parent.no)
        if nxt is None or nxt.indent < indent:
            return None
        if nxt.indent > indent:
            return self.block(nxt.indent)
        return None

    def _map(self, indent: int) -> dict:
        out: dict = {}
        while (line := self._peek()) is not None and line.indent == indent:
            kv = _split_key(line)
            if kv is None:
                _fail(line.no, f"expected `key: value`, got {line.text!r}")
            key, rest = kv
            if key in out:
                _fail(line.no, f"duplicate key {key!r}")
            self.i += 1
            nxt = self._peek()
            if (not rest and nxt is not None and nxt.indent == indent
                    and (nxt.text == "-" or nxt.text.startswith("- "))):
                out[key] = self._seq(indent)  # `key:` then `- item` lines
            else:
                out[key] = self._child(line, rest, indent)
        line = self._peek()
        if line is not None and line.indent > indent:
            _fail(line.no, "unexpected indentation")
        return out

    def _seq(self, indent: int) -> list:
        out: list = []
        while (line := self._peek()) is not None and line.indent == indent:
            if not (line.text == "-" or line.text.startswith("- ")):
                break
            rest = line.text[1:].lstrip()
            if rest and (rest.startswith("- ") or rest == "-"
                         or _split_key(_Line(0, rest, line.no)) is not None):
                # `- key: value` / `- - x`: the item is a block whose first
                # line sits at the column of its text.
                col = indent + len(line.text) - len(rest)
                self.lines[self.i] = _Line(col, rest, line.no)
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(self._child(line, rest, indent))
        line = self._peek()
        if line is not None and line.indent > indent:
            _fail(line.no, "unexpected indentation")
        return out


def _lines(text: str) -> list[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body:
            _fail(no, "tabs are not allowed")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            _fail(no, "document markers and directives are not supported")
        out.append(_Line(len(body) - len(stripped), stripped, no))
    return out


def loads(text: str):
    """Parse a job spec's text (see the module docstring for the subset)."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.block(lines[0].indent)
    if parser.i != len(lines):
        line = lines[parser.i]
        _fail(line.no, f"unexpected {line.text!r} (bad indentation?)")
    return value


def load(path: str):
    """Parse the job spec at ``path``."""
    with open(path) as f:
        return loads(f.read())
