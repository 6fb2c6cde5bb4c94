"""The port's knob registry (`horovod_tpu_torch.analysis.registry`) against
the JAX package's: every knob declared in both has the same type and
default (the port's own rows say why they differ), the typed accessors
return the same values on the same environ dicts (drawn from a numpy
seed), every ``HVT_*`` literal the port reads is declared, and the port's
library reads no ``HVT_*`` variable past the accessors."""

import ast
import os
import re

import numpy as np
import pytest

from horovod_tpu.analysis import registry as jreg
from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
SHARED = sorted(set(treg.KNOBS) & set(jreg.KNOBS))
GETTERS = ("get_raw", "get_str", "get_int", "get_float", "get_flag")


def _sources():
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                with open(path) as f:
                    yield path, f.read()


def test_port_rows_are_exactly_the_documented_differences():
    own = {n for n, k in treg.KNOBS.items() if k.port}
    assert own == {"HVT_BACKEND", "HVT_DEVICE", "HVT_EXPORT_FORMAT"}
    assert set(treg.KNOBS) - set(jreg.KNOBS) == {"HVT_BACKEND", "HVT_DEVICE"}


@pytest.mark.parametrize("name", SHARED)
def test_shared_knob_matches_jax(name):
    t, j = treg.KNOBS[name], jreg.KNOBS[name]
    assert t.type == j.type
    if not t.port:
        assert t.default == j.default
    assert (t.tunable is None) == (j.tunable is None)
    if t.tunable is not None:
        assert t.tunable.domain_str() == j.tunable.domain_str()


def _value_for(knob, rng):
    if knob.type == "flag":
        return str(rng.choice(["", "0", "1", "true", "False", "no", "yes",
                               "On"]))
    if knob.type == "int":
        return str(rng.choice(["", str(int(rng.integers(-3, 10 ** 6)))]))
    if knob.type == "float":
        return str(rng.choice(["", f"{rng.normal():.6g}", "0"]))
    return str(rng.choice(["", "x", "/tmp/a b", "0:1:hang"]))


@pytest.mark.parametrize("seed", range(8))
def test_accessors_match_jax_on_the_same_environ(seed):
    rng = np.random.default_rng(seed)
    environ = {n: _value_for(treg.KNOBS[n], rng) for n in SHARED
               if rng.random() < 0.7}
    for name in SHARED:
        if treg.KNOBS[name].port:
            continue
        kind = treg.KNOBS[name].type
        getters = (("get_raw", "get_str") if kind not in
                   ("int", "float", "flag") else
                   ("get_raw", {"int": "get_int", "float": "get_float",
                                "flag": "get_flag"}[kind]))
        for g in getters:
            assert (getattr(treg, g)(name, environ=environ)
                    == getattr(jreg, g)(name, environ=environ)), (name, g)


@pytest.mark.parametrize("value", [None, "", "0", "false", "FALSE", "no",
                                   "1", "yes", "off", "anything"])
def test_flag_contract_matches_jax(value, monkeypatch):
    assert treg.flag_like(value) == jreg.flag_like(value)
    if value is None:
        monkeypatch.delenv("HVT_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("HVT_NO_NATIVE", value)
    assert runtime.env_flag("HVT_NO_NATIVE") == treg.flag_like(value)


def test_unknown_knob_refused():
    for g in GETTERS:
        with pytest.raises(treg.UnknownKnobError, match="HVT_NOPE"):
            getattr(treg, g)("HVT_NOPE", environ={})
    assert not treg.is_registered("HVT_NOPE")


def test_every_hvt_literal_of_the_port_is_declared():
    seen = set()
    for path, src in _sources():
        for m in re.finditer(r"[\"'](HVT_[A-Z0-9_]+)[\"']", src):
            seen.add(m.group(1))
            assert treg.is_registered(m.group(1)), (path, m.group(1))
    # Every declared knob is read (or refused) somewhere in the port.
    assert set(treg.KNOBS) <= seen | {"HVT_COORDINATOR_ADDRESS",
                                      "HVT_NUM_PROCESSES", "HVT_PROCESS_ID",
                                      "HVT_LOCAL_RANK", "HVT_BACKEND",
                                      "HVT_HEARTBEAT_DIR", "HVT_DCN_FACTOR"}


def test_no_direct_environ_reads_of_hvt_knobs():
    """The library reads knobs through the accessors: no
    ``os.environ.get("HVT_...")``, ``os.environ["HVT_..."]`` or
    ``os.getenv`` of a knob name outside ``examples/`` (entry scripts read
    their own knobs, as their JAX twins do)."""
    knob_consts = {"ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                   "ENV_LOCAL_RANK", "ENV_BACKEND", "ENV_HEARTBEAT_DIR",
                   "ENV_DCN_FACTOR", "ENV_FAULT", "ENV_FAULT_STAMP",
                   "ENV_FAULT_HOST_PIDS"}
    bad = []
    for path, src in _sources():
        if os.sep + "examples" + os.sep in path:
            continue
        for node in ast.walk(ast.parse(src)):
            key = None
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "getenv")
                    and "environ" in ast.unparse(node.func.value)
                    + node.func.attr):
                key = node.args[0]
            elif (isinstance(node, ast.Subscript)
                  and ast.unparse(node.value).endswith("environ")
                  and isinstance(node.ctx, ast.Load)):
                key = node.slice
            if key is None:
                continue
            text = ast.unparse(key)
            if "HVT_" in text or text.split(".")[-1] in knob_consts:
                bad.append((os.path.relpath(path, REPO), node.lineno, text))
    assert not bad, bad


def test_generate_doc_lists_every_knob():
    doc = treg.generate_doc()
    for name in treg.KNOBS:
        assert f"`{name}`" in doc
    assert "port-only" in doc and "autotuner domains" in doc
