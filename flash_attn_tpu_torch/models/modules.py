"""Attention modules (port of ``flash_attn_tpu/models/modules.py``).

``FlashAttention`` is the inner attention over packed qkv in the padded
``(b, s, 3, h, d)`` mode; ``FlashMHA`` is fused ``Wqkv`` -> flash attention
-> ``out_proj``, with the submodules named as in the flax tree. Dropout
takes its seed from an explicit ``torch.Generator`` passed to ``forward``
(the counterpart of ``_seed_from_rng_key``): one uint32 per call, keyed into
the kernels' coordinate hash, so nothing else is saved for the backward.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
``key_padding_mask`` (segments) and window, ALiBi and softcap (P2);
``cu_seqlens`` (the varlen interface) and rotary embeddings (P6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.ops.attention import flash_attention


def draw_seeds(generator: torch.Generator, n: int) -> list[int]:
    """``n`` uint32 seeds from ``generator``, on its device (one host sync
    for a CUDA generator)."""
    if generator is None:
        raise ValueError("dropout needs a torch.Generator")
    return torch.randint(0, 2 ** 32, (n,), generator=generator,
                         device=generator.device).tolist()


def linear(x, lin: nn.Linear, dtype):
    """``lin`` computed in ``dtype`` from its stored parameters, as a flax
    ``Dense(dtype=...)`` casts its fp32 params before the product (a no-op
    when they are stored in ``dtype``)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _unported(**given):
    items = {"key_padding_mask": "P2 (segments)", "window_size": "P2",
             "use_alibi": "P2", "softcap": "P2",
             "cu_seqlens": "P6 (varlen interface)",
             "use_rotary_emb": "P6 (rotary)"}
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}: ROADMAP port item {items[name]}")


class FlashAttention(nn.Module):
    """Inner scaled-dot-product attention over packed qkv (b, s, 3, h, d)."""

    def __init__(self, softmax_scale: float | None = None,
                 attention_dropout: float = 0.0, window_size=None,
                 use_alibi: bool = False, softcap: float | None = None):
        super().__init__()
        _unported(window_size=window_size, use_alibi=use_alibi,
                  softcap=softcap)
        self.softmax_scale = softmax_scale
        self.attention_dropout = attention_dropout

    def forward(self, qkv, key_padding_mask=None, causal: bool = False,
                cu_seqlens=None, max_s=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        _unported(key_padding_mask=key_padding_mask, cu_seqlens=cu_seqlens)
        if qkv.dim() != 5 or qkv.shape[2] != 3:
            raise ValueError(f"padded qkv must be (b, s, 3, h, d), got "
                             f"{tuple(qkv.shape)}")
        return self.attend(*qkv.unbind(dim=2), causal=causal,
                           deterministic=deterministic, generator=generator)

    def attend(self, q, k, v, *, causal: bool, deterministic: bool,
               generator: torch.Generator | None):
        """Attention over (b, s, h, d) q and (b, s, h_kv, d) k, v."""
        dropout_p = 0.0 if deterministic else self.attention_dropout
        seed = draw_seeds(generator, 1)[0] if dropout_p > 0.0 else None
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=self.softmax_scale,
                               dropout_p=dropout_p, dropout_seed=seed)


class FlashMHA(nn.Module):
    """Multi-head attention block: fused Wqkv -> flash attention ->
    out_proj. With GQA (``num_kv_heads`` < ``num_heads``) the projection
    splits as [hq * hd | hkv * hd | hkv * hd]. ``dtype`` is the compute
    dtype (None: the promotion of the input's and the parameters'), and
    ``param_dtype`` the stored one."""

    def __init__(self, embed_dim: int, num_heads: int,
                 num_kv_heads: int | None = None, bias: bool = True,
                 attention_dropout: float = 0.0, causal: bool = False,
                 use_rotary_emb: str | None = None,
                 softmax_scale: float | None = None, dtype=None,
                 param_dtype=torch.float32, window_size=None,
                 use_alibi: bool = False, softcap: float | None = None,
                 device=None):
        super().__init__()
        _unported(use_rotary_emb=use_rotary_emb)
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} must be a multiple of "
                             f"num_kv_heads {kv_heads}")
        self.embed_dim, self.num_heads, self.kv_heads = (
            embed_dim, num_heads, kv_heads)
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.dtype = dtype
        factory = dict(device=device, dtype=param_dtype)
        self.Wqkv = nn.Linear(embed_dim,
                              (num_heads + 2 * kv_heads) * self.head_dim,
                              bias=bias, **factory)
        self.inner_attn = FlashAttention(
            softmax_scale=softmax_scale, attention_dropout=attention_dropout,
            window_size=window_size, use_alibi=use_alibi, softcap=softcap)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias, **factory)

    def forward(self, x, key_padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        _unported(key_padding_mask=key_padding_mask)
        b, s, _ = x.shape
        hq, hkv, hd = self.num_heads, self.kv_heads, self.head_dim
        dtype = self.dtype if self.dtype is not None else \
            torch.promote_types(x.dtype, self.Wqkv.weight.dtype)
        qkv = linear(x, self.Wqkv, dtype)
        if hkv == hq:  # flax splits the fused projection as (3, h, hd)
            q, k, v = qkv.reshape(b, s, 3, hq, hd).unbind(dim=2)
        else:
            q = qkv[..., : hq * hd].reshape(b, s, hq, hd)
            k = qkv[..., hq * hd: (hq + hkv) * hd].reshape(b, s, hkv, hd)
            v = qkv[..., (hq + hkv) * hd:].reshape(b, s, hkv, hd)
        ctx = self.inner_attn.attend(q, k, v, causal=self.causal,
                                     deterministic=deterministic,
                                     generator=generator)
        return linear(ctx.reshape(b, s, self.embed_dim), self.out_proj, dtype)
