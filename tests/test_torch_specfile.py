"""The port's job-spec reader (`horovod_tpu_torch.launch.specfile`) against
``yaml.safe_load``: equal on every job spec of both packages, equal on the
scalar forms and structures job specs use, and a `ValueError` naming the
line on everything outside that subset — never a guess."""

import glob
import math
import os

import pytest
import yaml

from horovod_tpu_torch.launch import specfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = sorted(glob.glob(os.path.join(REPO, "horovod_tpu", "launch", "jobs",
                                      "*.yaml"))
               + glob.glob(os.path.join(REPO, "horovod_tpu_torch", "launch",
                                        "jobs", "*.yaml")))


def test_both_packages_ship_specs():
    names = [os.path.relpath(p, REPO) for p in SPECS]
    assert "horovod_tpu_torch/launch/jobs/mnist-ci.yaml" in names
    assert "horovod_tpu_torch/launch/jobs/mnist-ci-2proc.yaml" in names
    assert len(names) >= 12


@pytest.mark.parametrize("path", SPECS, ids=lambda p: os.path.relpath(p, REPO))
def test_spec_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert specfile.load(path) == want


SCALARS = [
    "1", "0", "-7", "+5", "-0", "1.5", "-2.25", "3.", "1.0e+3", "2.5E-2",
    ".5", "1e3", "-.5", ".inf", "-.Inf", "+.INF", "yes", "No", "TRUE",
    "false", "on", "OFF", "null", "Null", "~", "09", "1.2.3", "3.12",
    "/tmp/hvt-ci-models", "python -m horovod_tpu_torch.examples.x",
    "tcp://localhost:29500", "hvt_step_skew_ms{rank=\"0\"}", "a#b",
    "'single ''quoted'''", '"double \\"q\\" \\\\ x"',
    '"0..0.3"', "'0:30:hostdown'", "x y z",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_safe_load(text):
    doc = f"k: {text}\n"
    got, want = specfile.loads(doc)["k"], yaml.safe_load(doc)["k"]
    assert type(got) is type(want)
    assert got == want


def test_nan_resolves_as_safe_load():
    assert math.isnan(specfile.loads("k: .nan")["k"])
    assert math.isnan(yaml.safe_load("k: .nan")["k"])


STRUCTURES = [
    "a:\n  b:\n    c: 1\n  d: [x, 'y', \"z\", [1, 2], {e: f}]\n",
    "- a\n- b: 1\n  c: 2\n- - x\n  - y\n-\n  z: 1\n-\n",
    "top:\n- a\n- b\nother: {k: [1, {m: n}]}\n",
    "# comment\na: b  # trailing\n\n  # indented comment\nc: 'd'  # e\n",
    "restart:\nenv:\n  K: ''\n",
    "jobs:\n  - name: alpha\n    job:\n      nprocs: 1\n  - name: beta\n",
    "empty_list: []\nempty_map: {}\n",
    "7: seven\nnull: x\n",
    "",
    "# only a comment\n",
]


@pytest.mark.parametrize("doc", STRUCTURES)
def test_structures_equal_safe_load(doc):
    assert specfile.loads(doc) == yaml.safe_load(doc)


MALFORMED = [
    ("a: 0755", 1), ("a: 1_000", 1), ("a: 1:30", 1), ("a: 0x1f", 1),
    ("a: 0b101", 1), ("a: 2024-01-02", 1), ("a: &x 1", 1), ("a: *x", 1),
    ("a: !!str 1", 1), ("a: |\n  text", 2), ("a: >\n  text", 2),
    ("a: b\n  c", 2), ("a: 1\na: 2", 2), ("a:\tb", 1), ("\ta: 1", 1),
    ("---\na: 1", 1), ("a: [1, 2", 1), ("a: {b: 1", 1),
    ("a: 'open\n  close'", 2), ("a: \"bad \\q escape\"", 1),
    ("a: \"tab \\t\"", 1), ("a: \"line \\n\"", 1),
    ("a: \"hex \\x41\"", 1), ("a: \"unicode \\u00e9\"", 1),
    ("a: b: c", 1), ("- a\nb: 1", 2), ("a: 1\n b: 2", 2),
    ("x:\n  - a\n  b: 1", 3), ("a: [b: c]", 1), ("a: 'x' y", 1),
    ("<<: {a: 1}", 1), ("? a\n: b", 1),
]


@pytest.mark.parametrize("doc,line", MALFORMED)
def test_malformed_raises_with_line(doc, line):
    with pytest.raises(ValueError, match=f"^line {line}:"):
        specfile.loads(doc)


def test_load_reads_a_file(tmp_path):
    p = tmp_path / "job.yaml"
    p.write_text("name: t\njob:\n  command: [python, -c, pass]\n")
    assert specfile.load(str(p)) == {"name": "t", "job": {
        "command": ["python", "-c", "pass"]}}
