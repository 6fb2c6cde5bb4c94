"""The encoder-decoder family in the port (`models/seq2seq.py`) against the
JAX package's `Seq2SeqTransformer`, at ``tests/test_seq2seq.py``'s sizes
(vocab 32, d 64, 4 heads, 2 + 2 layers, S 12, T 10, a pad tail of 4):

* logits and every parameter's gradient of ``mean(logits²)``, from the
  same weights (the JAX init through `seq2seq_params_from_flax`), on the
  flash path (the port's plain versions on the CPU) and on
  ``attn="dense"``;
* decoder causality and padding invariance (the port alone, as JAX's
  tests hold its model);
* the converter's round trip and the flax tree's layout;
* greedy generation equal to JAX's `make_seq2seq_generate_fn` token for
  token and to the teacher-forced argmax; the eos fill; a sampled run in
  range;
* JAX's five errors, word for word;
* `param_specs` against JAX's on a ``data=4, model=2`` mesh, and a model
  built on that mesh holding, on every rank, its part of the one-rank
  weights under those placements (its compute on the mesh is
  tests/test_torch_seq2seq_tp.py's);
* three SGD Trainer steps on dict batches against JAX's Trainer: the
  losses, then the parameters (SGD: Adam's g / (|g| + eps) would turn the
  rounding of near-zero gradient elements, common at this width, into
  ±lr steps that say nothing of the dict feeding held here).

Tolerances: f32 on both sides, the same sums in other orders: logits and
gradients within 1e-5 of each tensor's largest element; losses within
1e-5; parameters after three SGD steps within 1e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.models import seq2seq as jseq
from horovod_tpu.models.transformer import ShardingConfig as JShard
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (
    seq2seq_kernels, seq2seq_params_from_flax, seq2seq_params_to_flax,
    shard_state_dict,
)
from horovod_tpu_torch.parallel import mesh as tmesh

VOCAB, PAD, BOS, EOS = 32, 0, 1, 2
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_enc_layers=2,
           n_dec_layers=2, dropout=0.0)
RTOL, PARAM_ATOL = 1e-5, 1e-5


def _batch(seed, b=2, s=12, t=10, pad_tail=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, size=(b, s)).astype(np.int32)
    if pad_tail:
        src[:, -pad_tail:] = PAD
    tgt = rng.randint(3, VOCAB, size=(b, t)).astype(np.int32)
    return {"src": src, "tgt": tgt}


def _pair(batch, attn="ring", seed=0):
    jm = jseq.Seq2SeqTransformer(sharding=JShard(attn=attn), **CFG)
    params = jm.init(jax.random.PRNGKey(seed),
                     jax.tree.map(jnp.asarray, batch))["params"]
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu",
                                 sharding=ttr.ShardingConfig(attn=attn))
    tm.load_state_dict(seq2seq_params_from_flax(jax.device_get(params), tm))
    return jm, params, tm


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("attn", ["ring", "dense"])
def test_logits_and_gradients_match_jax(attn):
    batch = _batch(1, pad_tail=4)
    jm, params, tm = _pair(batch, attn)
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jb)
        return (out.astype(jnp.float32) ** 2).mean(), out

    (_, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tout = tm(_t(batch))
    (tout.float() ** 2).mean().backward()
    _close(tout.detach(), jout, "logits")
    want = seq2seq_params_from_flax(jax.device_get(jgrads), tm)
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad, want[name], name)


def test_decoder_causality_and_padding_invariance():
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=2)
    batch = _t(_batch(2, pad_tail=5))
    with torch.no_grad():
        out1 = tm(batch)
        tgt2 = batch["tgt"].clone()
        tgt2[:, -1] = (tgt2[:, -1] + 5) % VOCAB
        out2 = tm({"src": batch["src"], "tgt": tgt2})
        np.testing.assert_allclose(out1[:, :-1], out2[:, :-1], atol=1e-6)
        src3 = torch.cat([batch["src"],
                          torch.full((2, 3), PAD, dtype=torch.int32)], 1)
        out3 = tm({"src": src3, "tgt": batch["tgt"]})
        np.testing.assert_allclose(out1, out3, atol=2e-5)


def test_converter_round_trip_and_layout():
    batch = _batch(3)
    _, params, tm = _pair(batch)
    tree = jax.device_get(params)
    back = seq2seq_params_to_flax(seq2seq_params_from_flax(tree, tm), tm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))
    # The layout: qkv split q | k | v inside each head, cross_kv k | v.
    d, h, hd = CFG["d_model"], CFG["n_heads"], CFG["d_model"] // 4
    blk = tree["decoder"]["Block_1"]
    assert blk["qkv"]["kernel"].shape == (d, h, 3 * hd)
    assert blk["cross_q"]["kernel"].shape == (d, h, hd)
    assert blk["cross_kv"]["kernel"].shape == (d, h, 2 * hd)
    assert blk["cross_out"]["kernel"].shape == (h, hd, d)
    assert {f"LayerNorm_{i}" for i in range(3)} <= set(blk)
    sd = tm.state_dict()
    kv = np.asarray(blk["cross_kv"]["kernel"])
    np.testing.assert_array_equal(  # v of head 2 = rows of the v half
        sd["decoder.blocks.1.cross_kv.weight"][h * hd + 2 * hd:
                                               h * hd + 3 * hd].numpy(),
        kv[:, 2, hd:].T)
    assert set(seq2seq_kernels(tm)) == set(sd)


def test_greedy_generation_matches_jax_and_teacher_forcing():
    batch = _batch(5, pad_tail=2)
    jm, params, tm = _pair(batch)
    jgen = jseq.make_seq2seq_generate_fn(jm, max_new_tokens=7, bos_id=BOS)
    want = np.asarray(jgen(params, jnp.asarray(batch["src"]),
                           jax.random.PRNGKey(1)))
    gen = tseq.make_seq2seq_generate_fn(tm, max_new_tokens=7, bos_id=BOS)
    got = gen(batch["src"]).numpy()
    np.testing.assert_array_equal(got, want)
    tf_in = np.concatenate([np.full((2, 1), BOS, np.int32), got[:, :-1]], 1)
    with torch.no_grad():
        tf = tm({"src": torch.from_numpy(batch["src"]),
                 "tgt": torch.from_numpy(tf_in)}).argmax(-1).numpy()
    np.testing.assert_array_equal(tf, got)
    # The steps ran through the runner (eagerly on the CPU).
    assert gen.steps.counts()["eager_steps"] == 6


def test_eos_fill_and_sampling():
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=6)
    src = _batch(6)["src"]
    gen = tseq.make_seq2seq_generate_fn(tm, max_new_tokens=12, bos_id=BOS,
                                        eos_id=EOS)
    out = gen(src).numpy()
    for row in out:
        hits = np.where(row == EOS)[0]
        if len(hits):
            assert (row[hits[0]:] == EOS).all()
    jm = jseq.Seq2SeqTransformer(**CFG)
    params = jm.init(jax.random.PRNGKey(0), jax.tree.map(
        jnp.asarray, _batch(6)))["params"]
    tm.load_state_dict(seq2seq_params_from_flax(jax.device_get(params), tm))
    want = np.asarray(jseq.make_seq2seq_generate_fn(
        jm, max_new_tokens=12, bos_id=BOS, eos_id=EOS)(
        params, jnp.asarray(src), jax.random.PRNGKey(2)))
    np.testing.assert_array_equal(gen(src).numpy(), want)
    sgen = tseq.make_seq2seq_generate_fn(tm, max_new_tokens=5, bos_id=BOS,
                                         temperature=0.8, top_k=8)
    out = sgen(src, torch.Generator().manual_seed(3)).numpy()
    assert out.shape == (2, 5) and (out >= 0).all() and (out < VOCAB).all()


def _message(fn, kind=ValueError):
    with pytest.raises(kind) as e:
        fn()
    return str(e.value)


def test_errors_word_for_word():
    batch = _batch(8, s=16, t=16, pad_tail=4)
    jb = jax.tree.map(jnp.asarray, batch)
    jsp = jmesh.build_mesh(jmesh.MeshSpec(data=2, seq=4))
    tsp = tmesh.build_mesh(tmesh.MeshSpec(data=2, seq=4), n_ranks=8, rank=0)
    # attn != "ring" on a seq mesh
    want = _message(lambda: jseq.Seq2SeqTransformer(
        sharding=JShard(mesh=jsp, attn="dense"), **CFG).init(
        jax.random.PRNGKey(0), jb))
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", sharding=(
        ttr.ShardingConfig(mesh=tsp, attn="dense")))
    assert _message(lambda: tm(_t(batch))) == want
    # q_ids is not kv_ids on the ring
    q = jnp.zeros((2, 16, 4, 16))
    ids = jnp.ones((2, 16), jnp.int32)
    want = _message(lambda: jseq._attention(
        JShard(mesh=jsp), q, q, q, causal=False, q_ids=ids,
        kv_ids=ids + 0))
    tq = torch.zeros(2, 4, 4, 16)
    tids = torch.ones(2, 4, dtype=torch.int32)
    assert _message(lambda: tseq._attention(
        ttr.ShardingConfig(mesh=tsp), tq, tq, tq, causal=False, q_ids=tids,
        kv_ids=tids + 0)) == want
    # decode mode on a live seq axis
    want = _message(lambda: jseq.Seq2SeqTransformer(
        sharding=JShard(mesh=jsp), **CFG).clone(
        decode=True, max_decode_len=8).init(
        jax.random.PRNGKey(0), {"src": jb["src"], "tgt": jb["tgt"][:, :1]}))
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu",
                                 sharding=ttr.ShardingConfig(mesh=tsp))
    mem = torch.zeros(2, 16, CFG["d_model"])
    valid = torch.ones(2, 16, dtype=torch.int32)
    assert _message(lambda: tm.decode_tokens(
        torch.ones(2, 1, dtype=torch.int32), mem, valid,
        max_decode_len=8)) == want
    assert _message(lambda: tseq.make_seq2seq_generate_fn(
        tm, max_new_tokens=4, bos_id=BOS)) == want
    # max_decode_len < t
    jm, params, tm = _pair(_batch(9))
    jdec = jm.clone(decode=True, max_decode_len=3)
    mem, valid = jm.apply({"params": params}, jnp.asarray(_batch(9)["src"]),
                          method=jseq.Seq2SeqTransformer.encode)
    want = _message(lambda: jdec.apply(
        {"params": params}, jnp.ones((2, 5), jnp.int32), mem, valid,
        method=jseq.Seq2SeqTransformer.decode_tokens, mutable=["cache"]))
    tmem, tvalid = tm.encode(torch.from_numpy(_batch(9)["src"]))
    assert _message(lambda: tm.decode_tokens(
        torch.ones(2, 5, dtype=torch.int32), tmem, tvalid,
        max_decode_len=3)) == want == "max_decode_len (3) < input length (5)"
    # max_new_tokens < 1
    want = _message(lambda: jseq.make_seq2seq_generate_fn(
        jm, max_new_tokens=0, bos_id=BOS))
    assert _message(lambda: tseq.make_seq2seq_generate_fn(
        tm, max_new_tokens=0, bos_id=BOS)) == want


def test_param_specs_match_jax_and_live_model_axis_is_cut():
    batch = _batch(10)
    _, params, tm = _pair(batch)
    jm_ = jmesh.build_mesh(jmesh.MeshSpec(data=4, model=2))
    tm_ = tmesh.build_mesh(tmesh.MeshSpec(data=4, model=2), n_ranks=8,
                           rank=0)
    jspecs = jseq.param_specs(params, jm_)
    tspecs = tseq.param_specs(tm, tm_)
    kernels = seq2seq_kernels(tm)
    sharded = 0
    for name, spec in tspecs.items():
        js = jspecs
        for key in kernels[name].path:
            js = js[key]
        js = tuple(js)
        want = {}
        if "model" in js:
            # JAX's kernel dim 0 (inputs: row-parallel) is the port's
            # [out, in] dim 1; its other dims (outputs) the port's dim 0.
            want = {1 if js.index("model") == 0 else 0: "model"}
            sharded += 1
        assert spec == want, (name, spec, js)
    # qkv, attn_out, mlp_up, mlp_down a block, cross_q/kv/out a decoder
    # block, and the LM head.
    assert sharded == 4 * 4 + 3 * 2 + 1
    # The placements are live, and the model built on the mesh holds its
    # part of the one-rank weights under them on every rank.
    live = ttr.live_placements(tspecs, tm_)
    assert len(live) == sharded
    one = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=3)
    for r in range(8):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(data=4, model=2), n_ranks=8,
                                rank=r)
        cut = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=3,
                                      sharding=ttr.ShardingConfig(mesh=mesh))
        assert cut.cuts == live
        want = shard_state_dict(one.state_dict(), mesh, live)
        for name, t in cut.state_dict().items():
            assert torch.equal(t, want[name]), (r, name)


def test_trainer_steps_on_dict_batches_match_jax():
    lr, steps = 0.5, 3
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(steps):
        src = rng.randint(3, VOCAB, (8, 12)).astype(np.int32)
        src[::2, -4:] = PAD
        y = src[:, :10].copy()
        tgt = np.concatenate([np.full((8, 1), BOS, np.int32), y[:, :-1]], 1)
        batches.append(({"src": src, "tgt": tgt}, y))
    jm = jseq.Seq2SeqTransformer(**CFG)
    jtrainer = hvt.Trainer(jm, hvt.DistributedOptimizer(optax.sgd(lr)),
                           loss="sparse_categorical_crossentropy", seed=0)
    jparams = jax.device_get(jtrainer.build(batches[0][0]).params)
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu")
    tm.load_state_dict(seq2seq_params_from_flax(jparams, tm))
    ttrainer = ht.Trainer(tm, ht.DistributedOptimizer(
        functools.partial(torch.optim.SGD, lr=lr)),
        loss="sparse_categorical_crossentropy", seed=0, device="cpu")
    jh = jtrainer.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                      verbose=0)
    th = ttrainer.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                      verbose=0)
    np.testing.assert_allclose([e["loss"] for e in th],
                               [e["loss"] for e in jh], atol=1e-5, rtol=0)
    np.testing.assert_allclose([e["accuracy"] for e in th],
                               [e["accuracy"] for e in jh], atol=1e-6)
    want = seq2seq_params_from_flax(jax.device_get(jtrainer.state.params), tm)
    for name, p in tm.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= PARAM_ATOL, (name, err)
