"""Attention modules (port of ``flash_attn_tpu/models/modules.py``).

``FlashAttention`` is the inner attention over packed qkv, in the three
input modes of the reference module (flash_attention.py:27-72 there):

  - padded ``(b, s, 3, h, d)``, no mask: K1/K2 directly;
  - padded with ``key_padding_mask`` (b, s): the batch stays padded and the
    kernels mask padding by segment ids (``ops/packing.py``
    ``make_segment_ids_from_mask``: each row segment 0, padding -1), as the
    JAX module does. Not unpad -> varlen -> pad: the dropout hash is keyed
    on the padded (b * h + head, row, col) coordinates, which packing would
    change, so the masks would no longer match JAX's bit for bit;
  - packed ``(nnz, 3, h, d)`` with ``cu_seqlens``: the varlen interface
    (``ops/interface.py``), which hashes the packed super-sequence's
    coordinates.

``FlashMHA`` is fused ``Wqkv`` -> optional rotary ("1d" or "2d",
``ops/rotary.py``) -> flash attention -> ``out_proj``, with the submodules
named as in the flax tree. Dropout takes its seed from an explicit
``torch.Generator`` passed to ``forward`` (the counterpart of
``_seed_from_rng_key``): one uint32 per call, keyed into the kernels'
coordinate hash, so nothing else is saved for the backward.

Both modules take the M4 terms of ``flash_attention``: a ``window_size``
band, ALiBi (``use_alibi``: the geometric slopes of ``alibi_slopes(h)``, or
explicit ``alibi_slopes``) and a logit ``softcap``. As in the JAX module the
cu_seqlens path refuses a window and ALiBi (use the padded mode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.ops.attention import alibi_slopes as make_slopes
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.interface import (
    flash_attn_unpadded_qkvpacked_func,
)
from flash_attn_tpu_torch.ops.packing import make_segment_ids_from_mask
from flash_attn_tpu_torch.ops.rotary import (
    RotaryEmbedding,
    RotaryEmbedding2D,
)


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


class FlashAttention(nn.Module):
    """Inner scaled-dot-product attention over packed qkv: (b, s, 3, h, d),
    with an optional (b, s) ``key_padding_mask`` (True at real tokens), or
    (nnz, 3, h, d) with ``cu_seqlens`` and ``max_s``."""

    def __init__(self, softmax_scale: float | None = None,
                 attention_dropout: float = 0.0, window_size=None,
                 use_alibi: bool = False, alibi_slopes=None,
                 softcap: float | None = None):
        super().__init__()
        self.softmax_scale = softmax_scale
        self.attention_dropout = attention_dropout
        self.window_size = window_size
        self.use_alibi = use_alibi
        self.alibi_slopes = alibi_slopes
        self.softcap = softcap

    def slopes(self, n_heads: int):
        """The ALiBi slopes of a call over ``n_heads`` query heads: the
        explicit ones, the geometric schedule with ``use_alibi``, or None."""
        if self.use_alibi and self.alibi_slopes is None:
            return make_slopes(n_heads)
        return self.alibi_slopes

    def forward(self, qkv, key_padding_mask=None, causal: bool = False,
                cu_seqlens=None, max_s=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        if cu_seqlens is not None:
            if qkv.dim() != 4 or qkv.shape[1] != 3:
                raise ValueError(f"packed qkv must be (nnz, 3, h, d), got "
                                 f"{tuple(qkv.shape)}")
            if max_s is None:
                raise ValueError("cu_seqlens requires max_s")
            if self.window_size is not None:
                raise ValueError(
                    "window_size is not supported on the cu_seqlens path; "
                    "use the padded mode (segment-id masking) instead")
            if self.slopes(qkv.shape[-2]) is not None:
                raise ValueError(
                    "ALiBi is not supported on the cu_seqlens path; "
                    "use the padded mode (segment-id masking) instead")
            dropout_p, seed = self.dropout_args(deterministic, generator)
            return flash_attn_unpadded_qkvpacked_func(
                qkv, cu_seqlens, max_s, dropout_p,
                softmax_scale=self.softmax_scale, causal=causal,
                dropout_seed=seed, softcap=self.softcap)
        if qkv.dim() != 5 or qkv.shape[2] != 3:
            raise ValueError(f"padded qkv must be (b, s, 3, h, d), got "
                             f"{tuple(qkv.shape)}")
        return self.attend(*qkv.unbind(dim=2), causal=causal,
                           key_padding_mask=key_padding_mask,
                           deterministic=deterministic, generator=generator)

    def dropout_args(self, deterministic: bool, generator):
        """(dropout_p, seed) of one call: a seed drawn from ``generator``
        when dropout is on."""
        dropout_p = 0.0 if deterministic else self.attention_dropout
        seed = draw_seeds(generator, 1)[0] if dropout_p > 0.0 else None
        return dropout_p, seed

    def attend(self, q, k, v, *, causal: bool, deterministic: bool,
               generator: torch.Generator | None, key_padding_mask=None):
        """Attention over (b, s, h, d) q and (b, s, h_kv, d) k, v; padding
        (``key_padding_mask`` False) masked by segment ids."""
        dropout_p, seed = self.dropout_args(deterministic, generator)
        seg = pos = None
        if key_padding_mask is not None:
            seg, pos = make_segment_ids_from_mask(key_padding_mask)
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=self.softmax_scale,
                               dropout_p=dropout_p, dropout_seed=seed,
                               q_segment_ids=seg, kv_segment_ids=seg,
                               q_positions=pos, kv_positions=pos,
                               window_size=self.window_size,
                               alibi_slopes=self.slopes(q.shape[2]),
                               softcap=self.softcap)


class FlashMHA(nn.Module):
    """Multi-head attention block: fused Wqkv -> optional rotary
    (``use_rotary_emb`` "1d" or "2d") -> flash attention -> out_proj. With
    GQA (``num_kv_heads`` < ``num_heads``) the projection splits as
    [hq * hd | hkv * hd | hkv * hd]. ``dtype`` is the compute
    dtype (None: the promotion of the input's and the parameters'), and
    ``param_dtype`` the stored one. The parameters are made on the card
    unless ``device`` says otherwise."""

    def __init__(self, embed_dim: int, num_heads: int,
                 num_kv_heads: int | None = None, bias: bool = True,
                 attention_dropout: float = 0.0, causal: bool = False,
                 use_rotary_emb: str | None = None,
                 softmax_scale: float | None = None, dtype=None,
                 param_dtype=torch.float32, window_size=None,
                 use_alibi: bool = False, alibi_slopes=None,
                 softcap: float | None = None, device="cuda"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if use_rotary_emb not in (None, "1d", "2d"):
            raise ValueError(f"use_rotary_emb: {use_rotary_emb}")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} must be a multiple of "
                             f"num_kv_heads {kv_heads}")
        self.embed_dim, self.num_heads, self.kv_heads = (
            embed_dim, num_heads, kv_heads)
        self.head_dim = embed_dim // num_heads
        self.rotary_emb = {None: None, "1d": RotaryEmbedding,
                           "2d": RotaryEmbedding2D}[use_rotary_emb]
        if self.rotary_emb is not None:
            self.rotary_emb = self.rotary_emb(self.head_dim)
        self.causal = causal
        self.dtype = dtype
        factory = dict(device=device, dtype=param_dtype)
        self.Wqkv = nn.Linear(embed_dim,
                              (num_heads + 2 * kv_heads) * self.head_dim,
                              bias=bias, **factory)
        self.inner_attn = FlashAttention(
            softmax_scale=softmax_scale, attention_dropout=attention_dropout,
            window_size=window_size, use_alibi=use_alibi,
            alibi_slopes=alibi_slopes, softcap=softcap)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias, **factory)

    def forward(self, x, key_padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
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
        if self.rotary_emb is not None:
            q, k = self.rotary_emb(q, k, seq_dimension=-3)
        ctx = self.inner_attn.attend(q, k, v, causal=self.causal,
                                     key_padding_mask=key_padding_mask,
                                     deterministic=deterministic,
                                     generator=generator)
        return linear(ctx.reshape(b, s, self.embed_dim), self.out_proj, dtype)
