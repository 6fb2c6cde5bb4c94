"""The twin of ``examples/seq2seq_translation.py``
(`horovod_tpu_torch.examples.seq2seq_translation`) at small knobs
(``DOCS=256``, ``DRIVE_EPOCHS=1``) on the CPU, against the JAX script run
on the same knobs from the same weights (the twin's seed-0 weights through
`seq2seq_params_to_flax`):

* the twin reads the JAX script's knobs and prints its lines, ending with
  ``REVERSAL LEARNED`` or ``NOT LEARNED``;
* its tokenizer file and its encoded ``(src, tgt_in, labels)`` arrays are
  byte-equal to the JAX script's;
* its first step's loss (before any update) equals the JAX script's;
* on the JAX script's own kind of mesh, ``HVT_MESH="data=2,model=2"`` at
  four gloo ranks through the port's launcher (the model in its Megatron
  cut, decoding on ``clone(sharding=ShardingConfig())``), its first
  step's loss over the global batch equals JAX's model's on the data
  shards' first batches from the same weights, and rank 0 prints the
  script's lines; the twin refuses to fall back to the CPU
  silently (`tests/test_torch_isolation.py`).

Tolerance: both scripts compute in f32; the first loss within 1e-5
relative.
"""

import importlib.util
import json
import os
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from horovod_tpu.data.tokenizer import ByteBPETokenizer as JTok
from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer as TTok
from horovod_tpu_torch.examples import seq2seq_translation as twin_mod
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, "horovod_tpu_torch", "examples",
                    "seq2seq_translation.py")
REF = os.path.join(REPO, "examples", "seq2seq_translation.py")
KNOBS = {"DOCS": "256", "DRIVE_EPOCHS": "1"}
TIMEOUT_S = 180
FIRST_LOSS_RTOL = 1e-5

TWIN_CHILD = r'''
import json, os
import numpy as np
import horovod_tpu_torch as hvt
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.examples import seq2seq_translation as twin
from horovod_tpu_torch.models.convert import seq2seq_params_to_flax

first = []


class First(callbacks.Callback):
    def on_batch_end(self, batch, logs=None):
        if not first:
            first.append(float(logs["loss"]))


fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    if "WEIGHTS" in os.environ:
        np.savez(os.environ["WEIGHTS"], tree=np.array(seq2seq_params_to_flax(
            self.module.state_dict(), self.module), dtype=object))
    kwargs["callbacks"] = list(kwargs.get("callbacks", [])) + [First()]
    return fit(self, *args, **kwargs)


hvt.Trainer.fit = recorded_fit
if "FIRST_BATCH" in os.environ:
    # Keep this rank's first training batch, as the feed hands it over.
    import pickle
    from horovod_tpu_torch.training import feeding
    pipeline = feeding.training_pipeline

    def kept(*args, **kwargs):
        it, close = pipeline(*args, **kwargs)

        def batches():
            for i, b in enumerate(it):
                if i == 0:
                    with open(os.environ["FIRST_BATCH"]
                              + f".{hvt.rank()}.pkl", "wb") as f:
                        pickle.dump(b, f)
                yield b
        return batches(), close

    feeding.training_pipeline = kept
twin.main()
if hvt.size() > 1:
    # The global batch's loss: the mean of the ranks' (equal row counts;
    # the model ranks of a data shard report the same).
    from horovod_tpu_torch.parallel import collectives
    first = [float(collectives.allreduce(np.array(first, np.float64))[0])]
if hvt.is_primary():
    print("FIRST", json.dumps(first), flush=True)
'''

JAX_CHILD = r'''
import json, os, runpy
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)  # one data shard, as the twin
import flax.linen as nn
import numpy as np
import horovod_tpu as hvt

weights = np.load(os.environ["WEIGHTS"], allow_pickle=True)["tree"].item()
init = nn.Module.init


def seeded_init(self, *args, **kwargs):
    variables = init(self, *args, **kwargs)
    if type(self).__name__ == "Seq2SeqTransformer":
        variables = dict(variables, params=weights)
    return variables


nn.Module.init = seeded_init
first = []


class First(hvt.callbacks.Callback):
    def on_batch_end(self, batch, logs=None):
        if not first:
            first.append(float(logs["loss"]))


fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    kwargs["callbacks"] = list(kwargs.get("callbacks", [])) + [First()]
    return fit(self, *args, **kwargs)


hvt.Trainer.fit = recorded_fit
runpy.run_path(os.environ["SCRIPT"], run_name="__main__")
print("FIRST", json.dumps(first), flush=True)
'''


def _knobs(path):
    with open(path) as f:
        return set(re.findall(r'os\.environ\.get\("([A-Z_]+)"', f.read()))


def test_twin_reads_the_reference_knobs():
    assert _knobs(REF) and _knobs(TWIN) == _knobs(REF)


def _run(cmd, env):
    return _wait(subprocess.Popen(cmd, cwd=REPO, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  start_new_session=True))


def _wait(proc):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out[-4000:]
    return out


def _first(out):
    line = re.search(r"FIRST (\[.*\])", out)
    assert line, out[-4000:]
    return json.loads(line.group(1))


def _lines(out):
    """The scripts' own lines, in order, without the epoch logs' numbers."""
    keep = ("dropped ", "byte-BPE vocab", "src:", "out:", "held-out",
            "REVERSAL")
    return [ln for ln in out.splitlines() if ln.startswith(keep)]


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_seq2seq_example", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The twin alone, the twin at ``data=2, model=2`` on four launched
    ranks (started first, running beside the others; each rank keeps its
    first batch), and the JAX script from the lone twin's weights: each
    one's output."""
    tmp = tmp_path_factory.mktemp("seq2seq_example")
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **KNOBS)
    tp = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.launch", "run", "--nprocs",
         "4", "--", sys.executable, "-c", TWIN_CHILD],
        cwd=REPO, env=dict(base, OMP_NUM_THREADS="1", HVT_DEVICE="cpu",
                           HVT_MESH="data=2,model=2",
                           FIRST_BATCH=str(tmp / "first"),
                           PS_MODEL_PATH=str(tmp / "tp")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        weights = str(tmp / "weights.npz")
        t_out = _run([sys.executable, "-c", TWIN_CHILD], dict(
            base, HVT_DEVICE="cpu", WEIGHTS=weights,
            PS_MODEL_PATH=str(tmp / "twin")))
        j_env = dict(base, WEIGHTS=weights, SCRIPT=REF, JAX_PLATFORMS="cpu",
                     PS_MODEL_PATH=str(tmp / "jax"))
        j_env["XLA_FLAGS"] = re.sub(
            r"--xla_force_host_platform_device_count=\d+", "",
            j_env.get("XLA_FLAGS", ""))
        j_out = _run([sys.executable, "-c", JAX_CHILD], j_env)
    except BaseException:
        os.killpg(tp.pid, signal.SIGKILL)
        raise
    tp_out = _wait(tp)
    return dict(tmp=tmp, twin=t_out, jax=j_out, tp=tp_out)


def test_twin_prints_the_jax_lines_from_the_same_data(runs):
    tmp_path, t_out, j_out = runs["tmp"], runs["twin"], runs["jax"]
    t_lines, j_lines = _lines(t_out), _lines(j_out)
    assert [ln.split(":")[0].split(" ")[0] for ln in t_lines] == \
        [ln.split(":")[0].split(" ")[0] for ln in j_lines]
    assert t_lines[0] == j_lines[0]  # the vocab and the pair count
    assert re.fullmatch(r"held-out reversal token accuracy: \d\.\d{3}",
                        t_lines[-2])
    assert re.fullmatch(r"REVERSAL (NOT )?LEARNED", t_lines[-1])
    # The tokenizer file, byte for byte.
    t_tok = tmp_path / "twin" / "seq2seq-reversal" / "tokenizer.json"
    j_tok = tmp_path / "jax" / "seq2seq-reversal" / "tokenizer.json"
    assert t_tok.read_bytes() == j_tok.read_bytes()
    # The encoded arrays, byte for byte, through each side's own code.
    jex = _jax_example()
    pairs = twin_mod.corpus(int(KNOBS["DOCS"]))
    assert pairs == jex.corpus(int(KNOBS["DOCS"]))
    t_arrays = twin_mod.encode_pairs(TTok.load(str(t_tok)), pairs, 16)
    j_arrays = jex.encode_pairs(JTok.load(str(j_tok)), pairs, 16)
    for a, b in zip(t_arrays, j_arrays):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # The first step's loss, from the same weights on the same batch.
    got, want = _first(t_out), _first(j_out)
    assert len(got) == len(want) == 1
    assert abs(got[0] - want[0]) <= FIRST_LOSS_RTOL * abs(want[0]), (
        got, want)


def _jax_loss(tree, batches):
    """JAX's model (the twin's configuration, from ``tree``) on the
    concatenated batches: the mean token cross-entropy (the scripts'
    ``sparse_categorical_crossentropy``)."""
    from horovod_tpu.models import seq2seq as jseq

    vocab, d = tree["encoder"]["embed"]["embedding"].shape
    jm = jseq.Seq2SeqTransformer(vocab_size=vocab, d_model=d, n_heads=4,
                                 n_enc_layers=2, n_dec_layers=2, dropout=0.0,
                                 pad_id=0)
    x = {k: np.concatenate([b[0][k] for b in batches]) for k in ("src",
                                                                 "tgt")}
    y = np.concatenate([b[1] for b in batches])
    logits = jm.apply({"params": tree}, x)
    logp = jax.nn.log_softmax(logits.astype(np.float32), -1)
    return float(-np.take_along_axis(np.asarray(logp), y[..., None],
                                     -1).mean())


def test_a_live_model_axis_matches_jax(runs):
    """The JAX script's ``data=4,model=2`` kind of mesh at four ranks
    (one process a rank: each data shard feeds its own batches, as JAX's
    processes do): the first step's loss over the global batch equals
    JAX's model's on the data shards' first batches, from the same
    weights; rank 0 (only) prints the script's lines."""
    import pickle

    tree = np.load(runs["tmp"] / "weights.npz",
                   allow_pickle=True)["tree"].item()
    shards = {}
    for r in range(4):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(data=2, model=2), n_ranks=4,
                                rank=r)
        with open(runs["tmp"] / f"first.{r}.pkl", "rb") as f:
            shards.setdefault(mesh.data_index, pickle.load(f))
    want = _jax_loss(tree, [shards[i] for i in sorted(shards)])
    got = _first(runs["tp"])
    assert len(got) == 1
    assert abs(got[0] - want) <= FIRST_LOSS_RTOL * abs(want), (got, want)
    lines = [ln.split("] ", 1)[1] for ln in runs["tp"].splitlines()
             if ln.startswith("[rank 0] ")]
    assert [ln.split(":")[0].split(" ")[0] for ln in _lines(
        "\n".join(lines))] == [ln.split(":")[0].split(" ")[0]
                               for ln in _lines(runs["jax"])]
    assert "[rank 1] REVERSAL" not in runs["tp"]
