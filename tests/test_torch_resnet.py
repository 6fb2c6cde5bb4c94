"""The port's `ResNetCIFAR` (depth 8) against the flax `ResNetCIFAR` through
`resnet_from_flax`: train-mode logits, the gradients of a mean
cross-entropy and the updated running statistics (flax's
``apply(..., mutable=["batch_stats"])``), then eval-mode logits on those
statistics; f64, f32 and bf16 compute; uint8 input; flax's asymmetric
"SAME" padding at stride 2; the depth check, the converter's round trip
and the seeded flax-shaped initialization.

Tolerances, each as a share of the tensor's largest magnitude:

* f64 on both sides (flax under ``jax.enable_x64``): 1e-6 — the logits are
  rounded to f32 on both sides (the models' contract), which bounds the
  agreement of everything downstream of the loss (measured 4e-8).
* f32: logits within 1e-5 of the f64 reference (measured 1.7e-7). The
  gradients of this ill-conditioned point (noise images at init, where the
  fast variance E[x²] − E[x]² of BN cancels on inputs of mean ~0.5) lie up
  to 1 % from the f64 reference in f32 on both sides, so each gradient and
  statistic of the port is held to be no further from the f64 reference
  than flax's own f32 run is, plus 1e-5 (measured: the port at 0.66 % where
  flax is at 0.96 %, and closer on every tensor).
* bf16: train and eval logits within two bf16 ulps (2 × 2^-8) of flax's
  bf16 logits, as in `tests/test_torch_cnn.py`; each updated statistic no
  further from the f64 reference than flax's bf16 one, plus two ulps. The
  bf16 gradients of this point are 2-30 % from the f64 reference on both
  sides, tensor by tensor (a max over 16 BN channels of such noise is no
  measure), so they are held on the whole: the mean over the tensors of
  the port's error is at most 1.5 × flax's. torch rounds every op's output
  to bf16 where XLA fuses the backward's elementwise chains and rounds at
  the fusion's end, so the port's bf16 carries more roundings (measured
  1.09-1.17 × over three batches).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models.resnet import ResNetCIFAR as FlaxResNet
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.convert import resnet_from_flax, resnet_to_flax
from horovod_tpu_torch.models.resnet import ResNetCIFAR

B, DEPTH = 16, 8
ULP2 = 2 * 2**-8


def _variables(seed=0):
    fm = FlaxResNet(depth=DEPTH)
    v = jax.device_get(fm.init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 32, 32, 3), jnp.float32)))
    # Running statistics away from their init (mean 0, variance 1), so
    # eval mode reads them.
    rng = np.random.RandomState(seed + 5)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a * (1 + rng.rand(*a.shape)) + 0.1 * rng.randn(*a.shape)
                   ).astype(np.float32) if a.min() > 0 else
        (0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def _inputs(kind="float32", seed=1):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    x = u8 if kind == "uint8" else u8.astype(np.float32) / 255.0
    return x, rng.randint(0, 10, B).astype(np.int32)


def _as(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _flax_run(v, x, y, dtype_name):
    """(train logits, {state_dict name: gradient or updated statistic},
    eval logits on the updated statistics) of the flax model."""
    jdt = getattr(jnp, dtype_name)
    wide = jnp.float64 if dtype_name == "float64" else jnp.float32
    fm = FlaxResNet(depth=DEPTH, compute_dtype=jdt)
    params, stats = _as(v["params"], wide), _as(v["batch_stats"], wide)
    xj = jnp.asarray(x) if x.dtype == np.uint8 else jnp.asarray(x, wide)

    def loss_fn(p):
        logits, upd = fm.apply({"params": p, "batch_stats": stats}, xj,
                               train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), (logits, upd)

    (_, (logits, upd)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    eval_logits = jax.jit(lambda p, u, x: fm.apply(
        {"params": p, **u}, x, train=False))(params, upd, xj)
    # Through the converter's f32 (6e-8 relative: far under every limit).
    out = {k: t.double().numpy() for k, t in resnet_from_flax(
        jax.device_get({"params": grads, **upd})).items()}
    return (np.asarray(logits, np.float64), out,
            np.asarray(eval_logits, np.float64))


def _torch_run(v, x, y, dtype_name):
    dt = getattr(torch, dtype_name)
    tm = ResNetCIFAR(depth=DEPTH, compute_dtype=dt, device="cpu")
    tm.load_state_dict(resnet_from_flax(v))
    xt = torch.from_numpy(x)
    if dtype_name == "float64":
        tm.double()
        xt = xt if x.dtype == np.uint8 else xt.double()
    logits = tm(xt, train=True)
    F.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    out = {n: p.grad.double().numpy() for n, p in tm.named_parameters()}
    out.update({n: b.double().numpy() for n, b in tm.named_buffers()})
    with torch.no_grad():
        eval_logits = tm(xt, train=False)
    return (logits.detach().double().numpy(), out,
            eval_logits.double().numpy())


@pytest.fixture(scope="module")
def runs():
    v = _variables()
    x, y = _inputs()
    out = {}
    for dt in ("float32", "bfloat16"):
        out[("flax", dt)] = _flax_run(v, x, y, dt)
        out[("port", dt)] = _torch_run(v, x, y, dt)
    with jax.enable_x64(True):
        out[("flax", "float64")] = _flax_run(v, x, y, "float64")
    out[("port", "float64")] = _torch_run(v, x, y, "float64")
    return out


def _err(a, b, scale):
    return float(np.abs(a - b).max()) / scale


def _scale(a):
    return max(float(np.abs(a).max()), 1e-30)


def test_f64_matches_flax_f64(runs):
    fl, fg, fe = runs[("flax", "float64")]
    tl, tg, te = runs[("port", "float64")]
    assert _err(tl, fl, _scale(fl)) <= 1e-6
    assert _err(te, fe, _scale(fe)) <= 1e-6
    assert set(tg) == set(fg)
    for n in fg:
        assert _err(tg[n], fg[n], _scale(fg[n])) <= 1e-6, n


def test_f32_matches_flax(runs):
    """Train and eval logits, gradients, updated statistics."""
    ref_l, ref_g, ref_e = runs[("flax", "float64")]
    fl, fg, fe = runs[("flax", "float32")]
    tl, tg, te = runs[("port", "float32")]
    for got, flax, ref, what in ((tl, fl, ref_l, "logits"),
                                 (te, fe, ref_e, "eval logits")):
        assert _err(got, ref, _scale(ref)) <= 1e-5, what
        assert _err(flax, ref, _scale(ref)) <= 1e-5, what
    for n in ref_g:
        s = _scale(ref_g[n])
        assert _err(tg[n], ref_g[n], s) <= 1e-5 + _err(fg[n], ref_g[n], s), n
    init = resnet_from_flax(_variables())
    for n in ref_g:  # the running statistics really moved
        if "running" in n:
            assert np.abs(tg[n] - init[n].numpy()).max() > 1e-3, n


def test_bf16_no_further_from_the_truth_than_flax_bf16(runs):
    ref_l, ref_g, ref_e = runs[("flax", "float64")]
    fl, fg, fe = runs[("flax", "bfloat16")]
    tl, tg, te = runs[("port", "bfloat16")]
    assert _err(tl, fl, _scale(fl)) <= ULP2
    assert _err(te, fe, _scale(fe)) <= ULP2
    port, flax = [], []
    for n in ref_g:
        s = _scale(ref_g[n])
        if "running" in n:
            assert _err(tg[n], ref_g[n], s) <= _err(fg[n], ref_g[n], s) \
                + ULP2, n
        else:
            port.append(_err(tg[n], ref_g[n], s))
            flax.append(_err(fg[n], ref_g[n], s))
    assert np.mean(port) <= 1.5 * np.mean(flax), (np.mean(port),
                                                  np.mean(flax))


def test_uint8_input_is_divided_on_the_device():
    v = _variables()
    x8, _ = _inputs("uint8")
    xf = x8.astype(np.float32) / 255.0
    tm = ResNetCIFAR(depth=DEPTH, device="cpu")
    tm.load_state_dict(resnet_from_flax(v))
    fm = FlaxResNet(depth=DEPTH)
    want = np.asarray(fm.apply(v, jnp.asarray(x8), train=False))
    got = tm(torch.from_numpy(x8), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    a = tm(torch.from_numpy(x8), train=False)
    assert torch.equal(a, tm(torch.from_numpy(xf), train=False))
    stats = {k: t.clone() for k, t in tm.state_dict().items()}
    a = tm(torch.from_numpy(x8), train=True)
    tm.load_state_dict(stats)
    assert torch.equal(a, tm(torch.from_numpy(xf), train=True))


def _symmetric_conv(x, conv, stride, dtype):
    """torch's ``nn.Conv2d(padding=k // 2)``: the same output shape as
    flax's SAME at stride 2, over windows shifted by one pixel."""
    k = conv.weight.shape[-1]
    return F.conv2d(x, conv.weight.to(dtype), None, stride, k // 2)


def test_stride2_blocks_pad_as_flax_does(monkeypatch):
    """A stride-2 3×3 conv pads (0, 1) in flax. The port's eval logits
    match; with torch's symmetric padding they would not."""
    v = _variables(seed=2)
    x, _ = _inputs(seed=3)
    want = np.asarray(FlaxResNet(depth=DEPTH).apply(v, jnp.asarray(x)))
    tm = ResNetCIFAR(depth=DEPTH, device="cpu")
    tm.load_state_dict(resnet_from_flax(v))
    tol = 1e-5 * np.abs(want).max()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= tol
    assert tm.blocks[1].stride == 2 and tm.blocks[1].projects
    monkeypatch.setattr(resnet, "_conv", _symmetric_conv)
    shifted = tm(torch.from_numpy(x)).detach().numpy()
    assert shifted.shape == want.shape
    assert np.abs(shifted - want).max() > 100 * tol


@pytest.mark.parametrize("depth", [7, 9, 19, 21])
def test_depth_must_be_6n_plus_2(depth):
    with pytest.raises(ValueError, match="6n\\+2"):
        ResNetCIFAR(depth=depth, device="cpu")


def test_converter_round_trip_and_layouts():
    v = _variables()
    sd = resnet_from_flax(v)
    back = resnet_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(
        {"params": v["params"], "batch_stats": v["batch_stats"]})
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves({"params": v["params"],
                                     "batch_stats": v["batch_stats"]})):
        assert a.shape == b.shape and np.array_equal(a, b)
    tm = ResNetCIFAR(depth=DEPTH, device="cpu")
    assert set(tm.state_dict()) == set(sd)
    for k, t in tm.state_dict().items():
        assert t.shape == sd[k].shape, k
    assert sd["conv.weight"].shape == (16, 3, 3, 3)  # OIHW
    assert sd["blocks.1.proj_conv.weight"].shape == (32, 16, 1, 1)
    assert "blocks.0.proj_conv.weight" not in sd  # identity shortcut
    # ResNet-20 holds the reference's ~270k parameters.
    assert sum(p.numel() for p in ResNetCIFAR(device="cpu").parameters()) \
        == sum(a.size for a in jax.tree.leaves(FlaxResNet(depth=20).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]))


def test_init_is_seeded_and_flax_shaped():
    a = ResNetCIFAR(depth=DEPTH, device="cpu", seed=3).state_dict()
    b = ResNetCIFAR(depth=DEPTH, device="cpu", seed=3).state_dict()
    c = ResNetCIFAR(depth=DEPTH, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.2.conv2.weight"],
                           c["blocks.2.conv2.weight"])
    for k, t in a.items():
        if k.endswith("running_var") or (".bn" in f".{k}" and
                                         k.endswith("weight")
                                         and "conv" not in k):
            assert torch.equal(t, torch.ones_like(t)), k
        elif k.endswith(("running_mean", "bias")):
            assert torch.equal(t, torch.zeros_like(t)), k
    w = a["blocks.2.conv2.weight"]  # lecun-normal: std 1/sqrt(fan_in)
    fan_in = 64 * 3 * 3
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
