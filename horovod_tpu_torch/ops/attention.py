"""Attention — port of `horovod_tpu.ops.attention` and of
`_dense_with_lse` in `horovod_tpu.ops.flash_attention`.

The dense functions materialize the ``[B, H, Tq, Tk]`` scores. They are the
numerics reference the CUDA flash kernel is held against on the card and
the path every CPU tensor takes. The sequence-parallel ones (the dense,
flash and cross rings and Ulysses) run over a process group, each rank
holding its shard of the sequence; their hops call the flash kernels.
Layout ``[batch, seq, heads, head_dim]`` in and out; statistics in float32
whatever the input dtype.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.parallel import collectives

# Finite stand-in for -inf: fully-masked rows stay at p == 0 through an
# explicit mask instead of producing NaN from inf - inf.
_BIG_NEG = -1e30


def check_window(window, causal) -> None:
    """Validate a sliding-window request (shared by every attention impl)."""
    if window is None:
        return
    if not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True — the "
            "band is defined as each query's `window` most recent keys"
        )
    if window < 1:
        raise ValueError(f"window must be a positive int, got {window}")


def _keep_mask(tq, tk, *, causal, offset, window, sinks, q_segment_ids,
               kv_segment_ids, device):
    """Boolean keep mask broadcastable to ``[B, H, Tq, Tk]``, or None when
    nothing is masked. Row r sits at key position r + ``offset``."""
    keep = None
    if causal:
        rows = torch.arange(tq, device=device)[:, None] + offset
        cols = torch.arange(tk, device=device)[None, :]
        keep = rows >= cols
        if window is not None:
            band = cols > rows - window
            if sinks:
                band = band | (cols < sinks)
            keep = keep & band
        keep = keep[None, None]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
        keep = seg if keep is None else keep & seg
    return keep


def acc(x):
    """``x`` in its accumulation dtype: f32 for f32/bf16 inputs, f64 for
    f64 (so a float64 gradcheck runs the same code in full precision)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k):
    """[B,Tq,H,D] x [B,Tk,H,D] -> [B,H,Tq,Tk] f32 logits, scaled."""
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bqhd,bkhd->bhqk", acc(q), acc(k)) * scale


def dense_attention(q, k, v, *, causal: bool = True, q_segment_ids=None,
                    kv_segment_ids=None, window: int | None = None,
                    sinks: int = 0):
    """Reference full-materialization attention (end-aligned causal mask,
    optional sliding window + sinks and segment-id equality). Fully
    masked rows give zero output."""
    check_window(window, causal)
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    s = _scores(q, k)
    tq, tk = s.shape[-2], s.shape[-1]
    keep = _keep_mask(
        tq, tk, causal=causal, offset=tk - tq, window=window, sinks=sinks,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        device=s.device,
    )
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _BIG_NEG))
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def dense_with_lse(q, k, v, *, causal: bool, q_segment_ids=None,
                   kv_segment_ids=None, window=None, q_offset=None, sinks=0):
    """Dense ``(out [B,Tq,H,D], lse [B,Tq,H])`` with the flash kernel's
    conventions: f32 statistics, a fully-masked row gives zero output and
    ``lse == _BIG_NEG``. ``q_offset`` overrides the end-aligned offset
    Tk − Tq (query row i sits at key position i + q_offset)."""
    s = _scores(q, k)
    tq, tk = s.shape[-2], s.shape[-1]
    off = tk - tq if q_offset is None else q_offset
    keep = _keep_mask(
        tq, tk, causal=causal, offset=off, window=window, sinks=sinks,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        device=s.device,
    )
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _BIG_NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        # Exact zeros, so a fully-masked row has l == 0, not Tk.
        p = torch.where(keep, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", acc((p / l_safe).to(v.dtype)), acc(v)
    ).to(q.dtype)
    lse = torch.where(
        empty, torch.full_like(m, _BIG_NEG), m + torch.log(l_safe)
    )[..., 0]  # [B,H,Tq]
    return out, lse.transpose(1, 2).contiguous()  # [B,Tq,H]


# --- Sequence parallelism ------------------------------------------------------
#
# The ring (Liu et al., arXiv:2310.01889) and Ulysses (Jacobs et al.,
# arXiv:2309.14509) forms of `horovod_tpu.ops.attention`, over a process
# group (a mesh's ``seq`` subgroup, `parallel.mesh.Mesh.group`) where JAX
# names a mesh axis. Each rank holds its ``[B, T/n, H, D]`` shard of the
# global sequence, shard c holding positions [c·T/n, (c+1)·T/n). K/V blocks
# travel r → r + 1 (`collectives.ring_shift`), so after i hops rank ``my``
# holds the block born at rank (my − i) mod n. JAX's scan makes n shifts,
# the last bringing the blocks home unused; here the ring makes n − 1. A
# group of one is exactly the local path, as JAX's degenerate axis is.


def ring_attention(q, k, v, *, group=None, causal: bool = True,
                   window: int | None = None):
    """Exact blockwise attention over a sequence-sharded ring, with dense
    per-hop scores (the numerics ground truth of the flash ring): each hop
    folds the local queries' attention to the block held into an online
    softmax (running max m, normalizer l, unnormalized output o), then the
    block moves on. ``window`` (requires ``causal``) is a band over GLOBAL
    positions; hops holding only stale or future keys contribute zero.
    K/V have q's heads."""
    check_window(window, causal)
    n, my = collectives.group_size(group), collectives.group_rank(group)
    b, t_local, h, d = q.shape
    scale = d ** -0.5
    dev = q.device
    q_pos = my * t_local + torch.arange(t_local, device=dev)
    o = torch.zeros((b, h, t_local, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t_local), _BIG_NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for i in range(n):
        j = (my - i) % n
        k_pos = j * t_local + torch.arange(t_local, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", acc(q), acc(k_blk)) * scale
        if causal:
            keep = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
            mask = keep.to(s.dtype)
        else:
            mask = torch.ones((t_local, t_local), dtype=s.dtype, device=dev)
        s = s + (1.0 - mask) * _BIG_NEG
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]) * mask
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", acc(p.to(v_blk.dtype)),
                          acc(v_blk))
        o = o * alpha[..., None] + pv
        m = m_new
        if i < n - 1:
            k_blk, v_blk = collectives.ring_shift(k_blk, v_blk, group=group)
    out = o / l[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _merge_lse(o, m, l, o_c, lse_c):
    """Fold one block's ``(out, lse)`` into the running (unnormalized out,
    max, normalizer): the logsumexp recurrence every ring variant
    shares."""
    m_new = torch.maximum(m, lse_c)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_c - m_new)
    return (o * alpha[..., None] + acc(o_c) * w[..., None], m_new,
            l * alpha + w)


class _NoKeys(torch.autograd.Function):
    """A hop whose block contributes nothing: zero output (and lse −BIG,
    set by the caller) that still depends on the block, with zero
    gradients for it. Without that dependency a rank whose hops all skip
    (the causal ring's first rank) would leave its shifts out of the
    backward while its peers' backward shifts wait for it."""

    @staticmethod
    def forward(ctx, like, k_blk, v_blk):
        ctx.kv = [(t.shape, t.dtype, t.device) for t in (k_blk, v_blk)]
        return torch.zeros_like(like)

    @staticmethod
    def backward(ctx, grad):
        return (None, *[torch.zeros(s, dtype=dt, device=dev)
                        for s, dt, dev in ctx.kv])


def _skip(q, k_blk, v_blk):
    b, t, h, _ = q.shape
    o = _NoKeys.apply(q, k_blk, v_blk)
    return o, torch.full((b, t, h), _BIG_NEG, dtype=torch.float32,
                         device=q.device)


def _ring_init(q):
    b, t, h, d = q.shape
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, t, h), _BIG_NEG, dtype=torch.float32, device=q.device)
    return o, m, torch.zeros_like(m)


def ring_cross_attention(q, k, v, *, group=None, q_segment_ids=None,
                         kv_segment_ids=None):
    """Non-causal CROSS-attention over a sequence-sharded ring (a seq2seq
    decoder's cross-attention): ``q`` is this rank's ``[B, Tq/n, H, D]``
    shard of the decoder tokens, ``k``/``v`` its ``[B, Tk/n, H, D]`` shard
    of the encoder memory. Each hop runs the flash kernel against one
    memory block and merges by the logsumexp recurrence. ``q_segment_ids``
    stay with the queries; ``kv_segment_ids`` rotate with their block. A
    query with no matching key anywhere (an all-pad source row) gets zero
    output."""
    from horovod_tpu_torch.ops.flash_attention import flash_attention_with_lse

    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids come as a pair (the "
            "source-side padding mask needs both sides labelled)"
        )
    n = collectives.group_size(group)
    o, m, l = _ring_init(q)
    k_blk, v_blk, ks_blk = k, v, kv_segment_ids
    for i in range(n):
        kw = ({} if q_segment_ids is None else
              dict(q_segment_ids=q_segment_ids, kv_segment_ids=ks_blk))
        o_j, lse_j = flash_attention_with_lse(q, k_blk, v_blk, causal=False,
                                              **kw)
        o, m, l = _merge_lse(o, m, l, o_j, lse_j)
        if i < n - 1:
            k_blk, v_blk, ks_blk = collectives.ring_shift(
                k_blk, v_blk, ks_blk, group=group)
    # An all-pad source row ends with o == 0 (every hop's block is empty),
    # and l counts one per hop, so the divide gives zero.
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _sink_contrib(q, k_blk, v_blk, ks_blk, segment_ids, *, my, window,
                  sinks):
    """``(out, lse)`` of this rank's queries against the sink columns of
    global block 0 (held here on this hop): columns < ``sinks`` and below
    the band, disjoint from every band tile, so nothing counts twice.
    Dense ``[T/n, sinks]`` scores."""
    t_local, d = q.shape[1], q.shape[-1]
    kb, vb = k_blk[:, :sinks], v_blk[:, :sinks]
    s = torch.einsum("bqhd,bkhd->bhqk", acc(q), acc(kb)) * d ** -0.5
    rows = (my * t_local + torch.arange(t_local, device=q.device))[:, None]
    cols = torch.arange(sinks, device=q.device)[None, :]
    keep = cols <= rows - window
    if ks_blk is not None:
        keep = (keep[None] & (segment_ids[:, :, None]
                              == ks_blk[:, None, :sinks]))[:, None]
    else:
        keep = keep[None, None]
    s = torch.where(keep, s, torch.full_like(s, _BIG_NEG))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - mx), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True)
    empty = lsum == 0.0
    l_safe = torch.where(empty, torch.ones_like(lsum), lsum)
    o = torch.einsum("bhqk,bkhd->bqhd", acc((p / l_safe).to(vb.dtype)),
                     acc(vb)).to(q.dtype)
    lse = torch.where(empty, torch.full_like(mx, _BIG_NEG),
                      mx + torch.log(l_safe))[..., 0]
    return o, lse.transpose(1, 2)


def ring_flash_attention(q, k, v, *, group=None, causal: bool = True,
                         segment_ids=None, window: int | None = None,
                         sinks: int = 0):
    """Ring attention whose hops are the flash kernel: each hop computes
    its block's ``(out, lse)`` with `flash_attention_with_lse` (B1 on the
    card; B2 + B3 in the backward, with the merge's lse cotangent folded
    into delta) and the hops merge by the logsumexp recurrence. A causal
    ring skips the hops of future blocks (half the block work).

    ``segment_ids`` (``[B, T/n]``, this rank's shard of the packed ids)
    keep equal-id pairs: the kv ids rotate with their K/V blocks.

    ``window`` (requires ``causal``): a band over GLOBAL positions. Each
    past hop at distance ``dist`` runs the kernel with ``q_offset = dist ·
    T/n``; a distance whose newest key is already stale is skipped. The
    ring still makes every shift: a window prunes work, not traffic.

    ``sinks`` (requires ``window``): the first ``sinks`` global positions
    stay visible beyond the band. They live in global block 0: the hop
    holding it adds a small dense contribution over the sink columns
    (`_sink_contrib`), merged like any hop. Needs ``sinks ≤ T/n``."""
    from horovod_tpu_torch.ops.flash_attention import flash_attention_with_lse

    check_window(window, causal)
    if sinks:
        if sinks < 0:
            raise ValueError(f"sinks must be >= 0, got {sinks}")
        if window is None:
            raise ValueError(
                "sinks need window set (full causal already sees them)"
            )
    n, my = collectives.group_size(group), collectives.group_rank(group)
    t_local = q.shape[1]
    if sinks > t_local:
        raise ValueError(
            f"sinks ({sinks}) must fit one sequence shard (T/n = {t_local})"
        )

    def hop(i, j, k_blk, v_blk, ks_blk):
        kw = ({} if segment_ids is None else
              dict(q_segment_ids=segment_ids, kv_segment_ids=ks_blk))
        if not causal:
            return flash_attention_with_lse(q, k_blk, v_blk, causal=False,
                                            **kw)
        if i > my:  # a future block (the hop distance wrapped)
            return _skip(q, k_blk, v_blk)
        if i == 0:  # the diagonal block
            return flash_attention_with_lse(q, k_blk, v_blk, causal=True,
                                            window=window, **kw)
        if window is None:
            return flash_attention_with_lse(q, k_blk, v_blk, causal=False,
                                            **kw)
        if i * t_local - (t_local - 1) >= window:
            return _skip(q, k_blk, v_blk)  # even its newest key is stale
        return flash_attention_with_lse(q, k_blk, v_blk, causal=True,
                                        window=window, q_offset=i * t_local,
                                        **kw)

    o, m, l = _ring_init(q)
    k_blk, v_blk, ks_blk = k, v, segment_ids
    for i in range(n):
        j = (my - i) % n
        o, m, l = _merge_lse(o, m, l, *hop(i, j, k_blk, v_blk, ks_blk))
        if sinks and j == 0:
            o, m, l = _merge_lse(o, m, l, *_sink_contrib(
                q, k_blk, v_blk, ks_blk, segment_ids, my=my, window=window,
                sinks=sinks))
        if i < n - 1:
            k_blk, v_blk, ks_blk = collectives.ring_shift(
                k_blk, v_blk, ks_blk, group=group)
    return (o / l[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, *, group=None, causal: bool = True,
                      segment_ids=None, window: int | None = None,
                      sinks: int = 0):
    """All-to-all sequence parallelism: swap seq sharding for head
    sharding (``[B, T/n, H, D]`` → ``[B, T, H/n, D]``), run the flash
    kernel over the full sequence locally, swap back. Needs ``H % n ==
    0``; per-token ``segment_ids`` are all-gathered to the full ``[B,
    T]``."""
    from horovod_tpu_torch.ops.flash_attention import flash_attention

    n = collectives.group_size(group)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the seq axis ({n})"
        )

    def to_heads(x):  # [B,T/n,H,D] -> [B,T,H/n,D]
        return collectives.all_to_all_tiled(x, group, 2, 1)

    seg_kw = {}
    if segment_ids is not None:
        full_ids = collectives.all_gather_tiled(segment_ids, group, 1)
        seg_kw = dict(q_segment_ids=full_ids, kv_segment_ids=full_ids)
    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal, window=window, sinks=sinks, **seg_kw)
    return collectives.all_to_all_tiled(out, group, 1, 2)
