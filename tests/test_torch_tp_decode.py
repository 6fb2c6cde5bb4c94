"""KV-cache generation on a live ``model`` axis: JAX's two ``TestSharded``
cases (`tests/test_decoding.py`), token for token, through the port's
launcher at four gloo ranks on the CPU.

* MHA on ``data=2,model=2`` (JAX's mesh), prompt ``[[3, 1, 4, 1], [2, 7,
  1, 8]]``, 10 new tokens;
* GQA (2 kv heads) on ``data=2,model=2``, prompt ``[[7, 8, 9, 1]]``, 10
  new tokens. JAX runs this case on ``data=1,model=2``; the port's launch
  is one world of four ranks for the file, and a rank's ``data``
  coordinate does not enter decoding (every rank decodes the whole prompt
  on its heads), so the port's ``model`` groups are the JAX case's.

Both start from JAX's ``init(PRNGKey(0))`` weights, converted and cut to
each rank's part (`convert.shard_state_dict`). Every rank's tokens must
equal JAX's unsharded and sharded ``generate`` and the port's one-rank
``generate`` exactly; the cache holds ``H_kv/2`` heads a rank. The steps
run eagerly under gloo (their collectives go through the host), as the
runner's counts show.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import decoding as jdec
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import decoding as tdec
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
VOCAB, NEW = 32, 10
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, dropout=0.0)
# name: (model knobs, prompt, JAX's mesh)
CASES = {
    "mha": ({}, [[3, 1, 4, 1], [2, 7, 1, 8]], dict(data=2, model=2)),
    "gqa": ({"n_kv_heads": 2}, [[7, 8, 9, 1]], dict(data=1, model=2)),
}

CHILD = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import decoding
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import shard_state_dict
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
cases = json.loads(os.environ["CASES"])
new = int(os.environ["NEW"])
mesh = tmesh.build_mesh(tmesh.MeshSpec(data=2, model=2))
res = {}
for name, (kw, prompt, _) in cases.items():
    model = ttr.TransformerLM(**cfg, **kw, device="cpu",
                              sharding=ttr.ShardingConfig(mesh=mesh))
    full = torch.load(os.path.join(out, name + ".pt"), weights_only=True)
    specs = ttr.live_placements(ttr.param_specs(model, mesh), mesh)
    model.load_state_dict(shard_state_dict(full, mesh, specs))
    fn = decoding.make_generate_fn(model, max_new_tokens=new)
    res[name + ".tokens"] = fn(torch.tensor(prompt)).numpy()
    res[name + ".steps"] = np.array([fn.steps.eager_steps,
                                     fn.steps.captures])
    res[name + ".cache"] = np.array(model.new_cache(1, 4)["Block_0"]["k"].shape)
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _jax_model(kw, mesh=None):
    return jtr.TransformerLM(**CFG, **kw, sharding=jtr.ShardingConfig(
        mesh=mesh, attn="ring"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_decode")
    params = {}
    for name, (kw, _, _) in CASES.items():
        params[name] = jax.device_get(_jax_model(kw).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"])
        torch.save(params_from_flax(params[name]), tmp / f"{name}.pt")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), CASES=json.dumps(CASES),
               NEW=str(NEW))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    refs = {}
    try:
        for name, (kw, prompt, spec) in CASES.items():
            p = np.asarray(prompt, np.int32)
            n = spec["data"] * spec["model"]
            mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec),
                                    devices=jax.devices()[:n])
            tm = ttr.TransformerLM(**CFG, **kw, device="cpu")
            tm.load_state_dict(params_from_flax(params[name]))
            refs[name] = dict(
                plain=np.asarray(jdec.generate(_jax_model(kw), params[name],
                                               p, NEW)),
                sharded=np.asarray(jdec.generate(_jax_model(kw, mesh),
                                                 params[name], p, NEW)),
                one=tdec.generate(tm, torch.from_numpy(p), NEW).numpy())
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    assert proc.returncode == 0, out
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NPROCS)]
    return dict(refs=refs, ranks=ranks)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_decode_matches_one_device_token_for_token(run, name):
    ref = run["refs"][name]
    np.testing.assert_array_equal(ref["sharded"], ref["plain"])
    np.testing.assert_array_equal(ref["one"], ref["plain"])
    for res in run["ranks"]:
        np.testing.assert_array_equal(res[name + ".tokens"], ref["plain"])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_cache_holds_local_kv_heads_and_steps_run_eager(run, name):
    h_kv = CASES[name][0].get("n_kv_heads", CFG["n_heads"])
    hd = CFG["d_model"] // CFG["n_heads"]
    for res in run["ranks"]:
        assert tuple(res[name + ".cache"]) == (1, 4, h_kv // 2, hd)
        eager, captures = res[name + ".steps"]
        assert (int(eager), int(captures)) == (NEW - 1, 0)
