"""Vision Transformer for CIFAR-scale images — port of
`horovod_tpu.models.vit` (the conv-free model the CIFAR example swaps in
with ``ARCH=vit``).

patchify (a reshape and one dense layer) → learned position embeddings
(and an optional ``cls`` token) → pre-LN encoder blocks with
bidirectional attention → LayerNorm → mean (or ``cls``) pool → dense head,
f32 logits. flax's defaults, not torch's:

* ``nn.LayerNorm`` has ε = 1e-6 and f32 statistics (`transformer.LayerNorm`
  with a bias), ``nn.gelu`` is the tanh approximation;
* patches are cut in NHWC order — ``[B, h/p, p, w/p, p, C]`` → ``[B, T,
  p·p·C]`` — so the ``embed`` kernel carries across unchanged;
* ``qkv`` is one projection laid out per head (``[d, H, 3·hd]`` in flax:
  q, k, v are each head's thirds); ``attn_out`` maps ``[H, hd]`` → d.

Attention is `ops.attention.dense_attention`, as in JAX: at T = (32/p)² =
64 patches the score matrix is tiny, so neither side takes the flash
kernel. Dropout (0 in the example) draws its masks from ``dropout_seed``
(`ops.dropout`): site 0 after the embedding, sites 1 + 2i and 2 + 2i in
block i.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.cnn import init_flax_style
from horovod_tpu_torch.models.transformer import LayerNorm, _dtype
from horovod_tpu_torch.ops.attention import dense_attention
from horovod_tpu_torch.ops.dropout import dropout
from horovod_tpu_torch.runtime import resolve_device


def _dense(layer: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class EncoderBlock(nn.Module):
    """LN → per-head qkv → bidirectional attention → ``attn_out`` →
    residual; LN → ``mlp_up`` → gelu(tanh) → ``mlp_down`` → residual."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, d_model // n_heads
        self.dropout, self.dtype = dropout, _dtype(compute_dtype)
        self.ln1 = LayerNorm(d_model, self.dtype, use_bias=True)
        self.qkv = nn.Linear(d_model, 3 * n_heads * self.head_dim)
        self.attn_out = nn.Linear(n_heads * self.head_dim, d_model)
        self.ln2 = LayerNorm(d_model, self.dtype, use_bias=True)
        self.mlp_up = nn.Linear(d_model, mlp_ratio * d_model)
        self.mlp_down = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x, *, train: bool = False, dropout_seed=None,
                site: int = 1):
        b, t, _ = x.shape
        cd, hd = self.dtype, self.head_dim
        drop = train and self.dropout > 0.0
        qkv = _dense(self.qkv, self.ln1(x), cd).view(b, t, self.n_heads,
                                                     3 * hd)
        q, k, v = qkv.split(hd, dim=-1)
        att = dense_attention(q, k, v, causal=False)  # [B, T, H, hd]
        out = _dense(self.attn_out, att.reshape(b, t, -1), cd)
        if drop:
            out = dropout(out, self.dropout, dropout_seed, site)
        x = x + out
        h = _dense(self.mlp_up, self.ln2(x), cd)
        h = _dense(self.mlp_down, F.gelu(h, approximate="tanh"), cd)
        if drop:
            h = dropout(h, self.dropout, dropout_seed, site + 1)
        return x + h


class ViT(nn.Module):
    """``[B, H, W, C]`` images (uint8 or float) → ``[B, num_classes]`` f32
    logits. Kernels lecun-normal and biases zero (flax's defaults), the
    position embedding normal(0.02), the ``cls`` token zero, from a CPU
    generator seeded with ``seed``. ``image_size``/``channels`` fix the
    position table's length (flax sizes it from the first input)."""

    def __init__(self, patch_size: int = 4, d_model: int = 256,
                 n_heads: int = 8, n_layers: int = 8, mlp_ratio: int = 4,
                 num_classes: int = 10, dropout: float = 0.0,
                 pool: str = "mean", compute_dtype=torch.float32, *,
                 image_size: int = 32, channels: int = 3, device="cuda",
                 seed: int = 0):
        super().__init__()
        if pool not in ("mean", "cls"):
            raise ValueError(f"pool must be 'mean' or 'cls', got {pool!r}")
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible "
                             f"by patch_size {patch_size}")
        dev = resolve_device(device)
        self.patch_size, self.pool, self.dropout = patch_size, pool, dropout
        self.compute_dtype = cd = _dtype(compute_dtype)
        t = (image_size // patch_size) ** 2 + (pool == "cls")
        self.embed = nn.Linear(patch_size * patch_size * channels, d_model)
        self.cls = (nn.Parameter(torch.zeros(1, 1, d_model))
                    if pool == "cls" else None)
        self.pos_embed = nn.Parameter(torch.zeros(1, t, d_model))
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, mlp_ratio, dropout, cd)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, cd, use_bias=True)
        self.head = nn.Linear(d_model, num_classes)
        self.reset_parameters(seed)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        # Dense kernels and every bias (LayerNorm's too) as flax does.
        init_flax_style(((n, p) for n, p in self.named_parameters()
                         if n.endswith(("weight", "bias"))), seed)
        g = torch.Generator().manual_seed(seed + 1)
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=g)
                             * 0.02)
        if self.cls is not None:
            self.cls.zero_()
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.scale.fill_(1.0)

    def forward(self, x, *, train: bool = False, dropout_seed=None):
        if train and self.dropout > 0.0 and dropout_seed is None:
            raise ValueError("train=True with dropout > 0 needs dropout_seed "
                             "(the trainer passes its per-step seed)")
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch_size {p}")
        if not torch.is_floating_point(x):
            x = x.float() / 255.0
        cd = self.compute_dtype
        x = x.to(cd).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), -1)
        x = _dense(self.embed, x, cd)
        if self.cls is not None:
            x = torch.cat([self.cls.to(cd).expand(b, 1, -1), x], dim=1)
        x = x + self.pos_embed.to(cd)
        if train and self.dropout > 0.0:
            x = dropout(x, self.dropout, dropout_seed, 0)
        for i, block in enumerate(self.blocks):
            x = block(x, train=train, dropout_seed=dropout_seed,
                      site=1 + 2 * i)
        x = self.ln_f(x)
        x = x[:, 0] if self.cls is not None else x.mean(dim=1)
        return _dense(self.head, x, cd).float()
