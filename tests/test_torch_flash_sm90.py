"""The tensor-core route of the port's flash attention (B1
``csrc/flash_fwd_sm90.cu``, B2 ``csrc/flash_bwd_dq_sm90.cu``, B3
``csrc/flash_bwd_dkv_sm90.cu``): what of it runs on the CPU.

* `_route` by dtype and head dim;
* the TMA tensor-map descriptions the wrappers compute in Python for the
  strided q/k/v views of `TransformerLM` (shape, byte strides, box), and the
  refusal of a base or stride off 16 bytes;
* precision rehearsals of the B2 and B3 arithmetic: dS (and, for B3, P)
  fed to the products as bf16 hi + lo pairs, at a reduced causal shape
  (B2·H4·T256·D64, bf16 inputs from a numpy seed), held to
  ``chip_smoke.py``'s bf16 ``GRAD_TOL`` against the plain
  `flash_bwd_dq_reference` / `flash_bwd_dkv_reference` and against the JAX
  kernels (interpret mode) run on the same residuals (out, lse);
* the lse/delta staging array B3 reads, the C entries' argument counts,
  and the build's library hash over the shared headers.

The kernels themselves run only on the card (`cuda`-marked tests below and
``chip_smoke.py``).
"""

import ctypes
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa

BF16 = torch.bfloat16
# chip_smoke.py's bf16 GRAD_TOL: rtol, and atol as a share of the largest
# magnitude of the tensor.
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-2, 1e-3


@pytest.mark.parametrize("dtype,d,route", [
    (BF16, 64, "tc"), (BF16, 40, "tc"), (BF16, 128, "tc"), (BF16, 8, "tc"),
    (BF16, 36, "simt"), (BF16, 136, "simt"), (BF16, 256, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_route_by_dtype_and_head_dim(dtype, d, route):
    assert tfa._route(dtype, d) == route


def _block_qkv(n_heads, n_kv_heads, d_model=128, b=2, t=96):
    model = TransformerLM(vocab_size=64, d_model=d_model, n_heads=n_heads,
                          n_kv_heads=n_kv_heads, n_layers=1,
                          compute_dtype=BF16, device="cpu", seed=0)
    x = torch.randn(b, t, d_model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model.blocks[0]._qkv(x)


@pytest.mark.parametrize("n_heads,n_kv_heads", [(4, None), (4, 2)],
                         ids=["fused_qkv", "gqa_q_and_kv_proj"])
def test_tma_descriptions_of_transformer_views(n_heads, n_kv_heads):
    q, k, v = _block_qkv(n_heads, n_kv_heads)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    row = 3 * h * d if n_kv_heads is None else 2 * hkv * d  # k/v row width
    for name, x, width, heads in (("q", q, 3 * h * d if n_kv_heads is None
                                   else h * d, h),
                                  ("k", k, row, hkv), ("v", v, row, hkv)):
        desc = tfa._tma_desc(x, name)
        assert desc[0] == x.data_ptr()
        assert desc[1:5] == (d, heads, t, b)          # dims, innermost first
        assert desc[5:8] == (2 * d, 2 * width, 2 * t * width)  # bytes
        assert desc[8:] == (64, 1, 64, 1)              # box: 64 cols, 64 rows
        # rising strides: H inside T inside B
        assert desc[5] < desc[6] < desc[7]
    if n_kv_heads is None:  # the three views of one fused projection
        assert (k.data_ptr() - q.data_ptr(),
                v.data_ptr() - q.data_ptr()) == (2 * h * d, 4 * h * d)
    arg = tfa._desc_arg(v, "v")
    assert len(arg) == 12 and tuple(arg) == tfa._tma_desc(v)


def test_tma_description_refuses_misalignment():
    x = torch.zeros(2, 16, 4, 72, dtype=BF16)
    with pytest.raises(ValueError, match="16-byte"):
        tfa._tma_desc(x[..., 1:65])          # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        tfa._tma_desc(torch.zeros(2, 16, 4, 36, dtype=BF16))  # H stride 72 B
    with pytest.raises(ValueError, match="contiguous"):
        tfa._tma_desc(torch.zeros(2, 16, 64, 4, dtype=BF16).transpose(2, 3))
    tfa._tma_desc(x[..., 8:72])              # 16 bytes off: taken


def test_tc_stats_layout():
    g = torch.Generator().manual_seed(1)
    lse, delta = (torch.randn(2, 77, 3, generator=g) for _ in range(2))
    stats = tfa._tc_stats(lse, delta)
    assert stats.shape == (2, 2, 3, 128) and stats.dtype == torch.float32
    torch.testing.assert_close(stats[0, :, :, :77], lse.transpose(1, 2))
    torch.testing.assert_close(stats[1, :, :, :77], delta.transpose(1, 2))
    assert (stats[..., 77:] == 0).all()


def _split(x):
    """x as a bf16 hi + lo pair, each back in f32 (the A operands of B3)."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def _tc_dkv(q, k, v, dout, lse, delta):
    """B3's tensor-core arithmetic in plain PyTorch (MHA): S and dP from the
    bf16 inputs in f32, P and dS fed as hi + lo pairs, f32 sums, one
    rounding to bf16 at the end."""
    qf, _, dof, p, ds = tfa._probs(q, k, v, dout, lse, delta)
    dk = sum(torch.einsum("bhqk,bqhd->bkhd", x, qf) for x in _split(ds))
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", x, dof) for x in _split(p))
    return (dk * q.shape[-1] ** -0.5).to(BF16), dv.to(BF16)


def _tc_dq(q, k, v, dout, lse, delta):
    """B2's tensor-core arithmetic in plain PyTorch (MHA): S and dP from the
    bf16 inputs in f32, dS fed as a hi + lo pair, f32 sums, one rounding to
    bf16 at the end."""
    _, kf, _, _, ds = tfa._probs(q, k, v, dout, lse, delta)
    dq = sum(torch.einsum("bhqk,bkhd->bqhd", x, kf) for x in _split(ds))
    return (dq * q.shape[-1] ** -0.5).to(BF16)


def _rehearsal_inputs(seed):
    """Causal B2·H4·T256·D64 bf16 inputs from a numpy seed, with the
    forward's out and lse and delta = rowsum(dO·O)."""
    rng = np.random.RandomState(seed)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 256, 4, 64).astype(
        np.float32)).to(BF16) for _ in range(4))
    out, lse = tfa.flash_attention_reference(q, k, v)
    return q, k, v, dout, out, lse, tfa._delta(out, dout, None)


def _jax_grads(q, k, v, dout, out, lse):
    """The JAX kernels (interpret mode) on the same residuals: f32 copies of
    the bf16 inputs and of the port's out, its lse as [B, H, T, 1]."""
    j = lambda x: jnp.asarray(x.float().numpy())  # noqa: E731
    res = (j(q), j(k), j(v), None, None, j(out),
           jnp.transpose(j(lse), (0, 2, 1))[..., None])
    grads = jfa._flash_bwd_core(True, None, 0, None, 64, 64, True, res,
                                j(dout), None)
    return [torch.from_numpy(np.array(x)) for x in grads[:3]]


def _tol_share(got, want):
    """The largest error as a share of chip_smoke's bf16 GRAD_TOL."""
    w = want.float()
    atol = GRAD_ATOL_OF_MAX * float(w.abs().max())
    err = (got.float() - w).abs()
    return float((err / (atol + GRAD_RTOL * w.abs())).max())


def _assert_grad_tol(got, want, name):
    share = _tol_share(got, want)
    assert share <= 1.0, f"{name}: {share:.3f} of chip_smoke's bf16 GRAD_TOL"


@pytest.mark.parametrize("seed", [0, 1])
def test_precision_rehearsal_of_tc_dq(seed):
    q, k, v, dout, out, lse, delta = _rehearsal_inputs(seed)
    dq = _tc_dq(q, k, v, dout, lse, delta)
    ref_dq = tfa.flash_bwd_dq_reference(q, k, v, dout, lse, delta)
    _assert_grad_tol(dq, ref_dq, "dq vs plain")
    # One bf16 rounding of dS (no lo product) lands further off.
    _, kf, _, _, ds = tfa._probs(q, k, v, dout, lse, delta)
    dq1 = (torch.einsum("bhqk,bkhd->bqhd", ds.to(BF16).float(), kf)
           * q.shape[-1] ** -0.5).to(BF16)
    assert _tol_share(dq, ref_dq) < _tol_share(dq1, ref_dq)
    _assert_grad_tol(dq, _jax_grads(q, k, v, dout, out, lse)[0], "dq vs jax")


@pytest.mark.parametrize("seed", [0, 1])
def test_precision_rehearsal_of_tc_dkv(seed):
    q, k, v, dout, out, lse, delta = _rehearsal_inputs(seed)
    d = q.shape[-1]
    dk, dv = _tc_dkv(q, k, v, dout, lse, delta)
    ref_dk, ref_dv = tfa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta)
    _assert_grad_tol(dk, ref_dk, "dk vs plain")
    _assert_grad_tol(dv, ref_dv, "dv vs plain")
    # One bf16 rounding of P and dS (no lo products) lands further off.
    qf, _, dof, p, ds = tfa._probs(q, k, v, dout, lse, delta)
    r = lambda x: x.to(BF16).float()  # noqa: E731
    dk1 = (torch.einsum("bhqk,bqhd->bkhd", r(ds), qf) * d ** -0.5).to(BF16)
    dv1 = torch.einsum("bhqk,bqhd->bkhd", r(p), dof).to(BF16)
    assert _tol_share(dk, ref_dk) < _tol_share(dk1, ref_dk)
    assert _tol_share(dv, ref_dv) < _tol_share(dv1, ref_dv)
    jax_dk, jax_dv = _jax_grads(q, k, v, dout, out, lse)[1:]
    _assert_grad_tol(dk, jax_dk, "dk vs jax")
    _assert_grad_tol(dv, jax_dv, "dv vs jax")


def test_build_hash_covers_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90",
             "flash_fwd")
    before = {n: _build.library_path(n, str(csrc)) for n in names}
    assert before == {n: _build.library_path(n) for n in names}
    header = csrc / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n, str(csrc)) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in after.values())


def test_build_passes_csrc_include(monkeypatch, tmp_path):
    """nvcc gets ``-I csrc`` (the kernels include "sm90.cuh")."""
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        with open(cmd[cmd.index("-o") + 1], "wb"):
            pass
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_libs", {})
    lib = _build.library("flash_fwd_sm90")
    cmd = seen["cmd"]
    assert cmd[cmd.index("-I") + 1] == _build.CSRC
    assert cmd[-1].endswith("flash_fwd_sm90.cu")
    assert os.path.basename(lib).startswith("libflash_fwd_sm90-")


# The C entries of the tensor-core kernels and their argument counts
# (hvt_flash_fwd_sm90: 3 descriptions, 4 pointers, 10 ints, scale, stream).
@pytest.mark.parametrize("name,n_args", [
    ("flash_fwd_sm90", 19), ("flash_bwd_dq_sm90", 21),
    ("flash_bwd_dkv_sm90", 22),
])
def test_tc_entry_argtypes(monkeypatch, name, n_args):
    entry = types.SimpleNamespace()
    lib = types.SimpleNamespace(**{f"hvt_{name}": entry})
    monkeypatch.setattr(_build, "library", lambda n: lib)
    monkeypatch.setattr(tfa, "_fns", {})
    assert tfa._kernel(name) is entry
    assert len(entry.argtypes) == n_args and entry.restype is ctypes.c_int
    assert entry.argtypes[-2] is ctypes.c_float  # scale, then the stream


def test_cpu_calls_count_no_tc_launch():
    g = torch.Generator().manual_seed(2)
    q, k, v, dout = (torch.randn(1, 64, 2, 64, generator=g).to(BF16)
                     for _ in range(4))
    counts = lambda: (tfa.launches_tc, tfa.launches_bwd_dq,  # noqa: E731
                      tfa.launches_bwd_dq_tc, tfa.launches_bwd_dkv_tc)
    before = counts()
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    delta = tfa._delta(out, dout, None)
    dq = tfa.flash_bwd_dq(q, k, v, dout, lse, delta)
    tfa.flash_bwd_dkv(q, k, v, dout, lse, delta)
    assert counts() == before
    torch.testing.assert_close(
        dq, tfa.flash_bwd_dq_reference(q, k, v, dout, lse, delta))


# -- the kernels (skip without a card) ------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have no "
                    "CPU mode; chip_smoke.py covers them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,layout", [(64, "qkv"), (40, "separate"),
                                      (128, "separate")])
def test_tc_kernels_match_plain_version(cuda, d, layout):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, t, h = 2, 200, 4
    if layout == "qkv":
        fused = torch.randn(b, t, 3 * h * d, generator=g, device=cuda)
        q, k, v = (x.view(b, t, h, d) for x in fused.to(BF16).split(h * d, -1))
    else:
        q, k, v = (torch.randn(b, t, h, d, generator=g, device=cuda).to(BF16)
                   for _ in range(3))
    before = (tfa.launches_tc, tfa.launches_bwd_dq_tc,
              tfa.launches_bwd_dkv_tc)
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    dout = torch.randn(b, t, h, d, generator=g, device=cuda).to(BF16)
    delta = tfa._delta(out, dout, None)
    dq = tfa.flash_bwd_dq(q, k, v, dout, lse, delta)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, dout, lse, delta)
    torch.cuda.synchronize()
    assert (tfa.launches_tc, tfa.launches_bwd_dq_tc,
            tfa.launches_bwd_dkv_tc) == tuple(n + 1 for n in before)
    ro, rl = tfa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), ro.float(), atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=0)
    _assert_grad_tol(dq, tfa.flash_bwd_dq_reference(q, k, v, dout, lse, delta),
                     "dq")
    for got, want, n in zip((dk, dv), tfa.flash_bwd_dkv_reference(
            q, k, v, dout, lse, delta), ("dk", "dv")):
        _assert_grad_tol(got, want, n)
