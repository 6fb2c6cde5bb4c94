"""Prometheus text-format exposition over the typed registry — port of
`horovod_tpu.obs.prom`.

`render` turns a `Registry.collect()` into the text exposition format
(version 0.0.4): ``# HELP``/``# TYPE`` per family, one sample line per
series, histograms as cumulative ``_bucket{le=...}`` series with the
``+Inf`` bucket, ``_sum`` and ``_count``. HELP/TYPE present for every
family, bucket counts non-decreasing and ``+Inf`` == ``_count`` hold by
construction.

`parse_text` is the inverse: a minimal parser of the same format back
into ``{series_name: value}``, what a gate reading a scrape uses.
"""

from __future__ import annotations

import math

from horovod_tpu_torch.obs import core

# The exposition content type every scrape endpoint must serve.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(value: float) -> str:
    """Sample-value formatting: integers render bare (promtool-friendly),
    specials use Prometheus spellings."""
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    return (
        text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _labels_str(names: tuple, values: tuple, extra: tuple = ()) -> str:
    pairs = [
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    ] + [f'{n}="{escape_label_value(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry: core.Registry | None = None) -> str:
    """The full ``GET /metrics`` body for ``registry`` (default: the
    module-level default registry)."""
    reg = registry if registry is not None else core.default_registry()
    lines: list[str] = []
    for spec, series in reg.collect():
        lines.append(f"# HELP {spec.name} {escape_help(spec.help)}")
        lines.append(f"# TYPE {spec.name} {spec.kind}")
        for label_values, value in series:
            if spec.kind == "histogram":
                cum = 0
                for edge, n in zip(spec.buckets, value.counts):
                    cum += n
                    lab = _labels_str(
                        spec.labels, label_values, extra=(("le", _fmt(edge)),)
                    )
                    lines.append(f"{spec.name}_bucket{lab} {cum}")
                lab = _labels_str(
                    spec.labels, label_values, extra=(("le", "+Inf"),)
                )
                lines.append(f"{spec.name}_bucket{lab} {value.count}")
                base = _labels_str(spec.labels, label_values)
                lines.append(f"{spec.name}_sum{base} {_fmt(value.sum)}")
                lines.append(f"{spec.name}_count{base} {value.count}")
            else:
                lab = _labels_str(spec.labels, label_values)
                lines.append(f"{spec.name}{lab} {_fmt(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def write_http(handler, registry: core.Registry | None = None) -> None:
    """Render ``registry`` and write it as a complete HTTP 200 response
    on a ``BaseHTTPRequestHandler`` — the ONE implementation of the
    ``GET /metrics`` response shared by every mount point (the serving
    server, the router, obs/server.py), so the content type and framing
    cannot drift between them."""
    body = render(registry).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def parse_text(text: str) -> dict:
    """Parse a text exposition back into ``{series: value}``.

    Keys are the bare family name for unlabeled series and
    ``name{label="v",...}`` (exactly as rendered) for labeled ones.
    Comment and blank lines are skipped; a malformed line raises (a gate
    reading a torn dump must fail loudly, not pass vacuously)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # Split at the LAST space: label values may contain escaped
        # spaces-free content, but be defensive about future timestamps.
        name, _, value = line.rpartition(" ")
        if not name:
            raise ValueError(f"malformed exposition line: {line!r}")
        out[name] = float(value)
    return out
