"""Rotary position embeddings, 1-D and 2-D (port of
``flash_attn_tpu/ops/rotary.py``).

The reference's ``flash_attn/rotary.py`` semantics: GPT-NeoX-style
interleaved pairs (x0, x1) -> (-x1, x0), inv_freq = base^(-2i/d), cos/sin
tables with every column duplicated per pair, and the 2-D form for
sqrt(S) x sqrt(S) grids (ViT), which rotates the first half of the head
dim along the grid's columns and the second half along its rows. Tables
are computed per call in fp32 and cast to the input's dtype, as the JAX
functions do. Plain torch: elementwise work, no kernel.
"""

from __future__ import annotations

import math

import torch


def rotary_cos_sin(seqlen: int, dim: int, *, base: float = 10000.0,
                   dtype=torch.float32, device=None):
    """cos and sin tables (seqlen, dim), columns duplicated per pair."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(seqlen, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    cos = freqs.cos().repeat_interleave(2, dim=-1).to(dtype)
    sin = freqs.sin().repeat_interleave(2, dim=-1).to(dtype)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: (x0, x1) -> (-x1, x0) per adjacent pair."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, seq_dimension: int = -2):
    """x * cos + rotate_half(x) * sin over the first s rows of the tables;
    ``seq_dimension`` -2 for (..., s, d), -3 for (..., s, h, d)."""
    if seq_dimension not in (-2, -3):
        raise ValueError(f"seq_dimension must be -2 or -3, got "
                         f"{seq_dimension}")
    s = x.shape[seq_dimension]
    cos, sin = cos[:s], sin[:s]
    if seq_dimension == -3:
        cos, sin = cos[:, None, :], sin[:, None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return x * cos + rotate_half(x) * sin


def apply_rotary_at_positions(x: torch.Tensor, positions: torch.Tensor,
                              dim: int | None = None, *,
                              base: float = 10000.0) -> torch.Tensor:
    """Rotary at explicit per-token positions (decode offsets, varlen):
    x (..., s, d) with ``positions`` broadcasting to (..., s), or to (...,
    s, 1) for x (..., s, h, d)."""
    d = x.shape[-1] if dim is None else dim
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=x.device) / d))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    cos = freqs.cos().repeat_interleave(2, dim=-1).to(x.dtype)
    sin = freqs.sin().repeat_interleave(2, dim=-1).to(x.dtype)
    return x * cos + rotate_half(x) * sin


class RotaryEmbedding:
    """1-D rotary (rotary.py:45-100 there): ``q_rot, k_rot = rot(q, k,
    seq_dimension=-2)``, the tables sized by k's sequence length."""

    def __init__(self, dim_model: int, *, base: float = 10000.0):
        self.dim_model = dim_model
        self.base = base

    def __call__(self, q, k, seq_dimension: int = -2):
        if seq_dimension not in (-2, -3):
            raise ValueError("seq_dimension must be -2 or -3")
        cos, sin = rotary_cos_sin(k.shape[seq_dimension], self.dim_model,
                                  base=self.base, device=q.device)
        return (apply_rotary_pos_emb(q, cos, sin, seq_dimension),
                apply_rotary_pos_emb(k, cos, sin, seq_dimension))


class RotaryEmbedding2D:
    """2-D rotary for a sqrt(S) x sqrt(S) token grid (rotary.py:103-135
    there): the first half of the head dim rotates along the grid's
    columns, the second half along its rows."""

    def __init__(self, dim: int, *, base: float = 10000.0):
        if dim % 4:
            raise ValueError(f"2D rotary needs dim % 4 == 0, got {dim}")
        self.dim = dim
        self.rotary_1d = RotaryEmbedding(dim // 2, base=base)

    def __call__(self, q, k, seq_dimension: int = -2):
        if seq_dimension not in (-2, -3):
            raise ValueError("seq_dimension must be -2 or -3")
        if seq_dimension == -3:  # (b, s, h, d) -> (b, h, s, d)
            q, k = q.transpose(-3, -2), k.transpose(-3, -2)
        seqlen = q.shape[-2]
        side = math.isqrt(seqlen)
        if side * side != seqlen:
            raise ValueError(f"2D rotary needs a square grid, got S={seqlen}")

        def grid(x):  # (..., s, d2) -> (..., side, side, d2)
            return x.unflatten(-2, (side, side))

        half = q.shape[-1] // 2
        q0, k0 = self.rotary_1d(grid(q[..., :half]), grid(k[..., :half]),
                                seq_dimension=-2)
        q1, k1 = self.rotary_1d(grid(q[..., half:]), grid(k[..., half:]),
                                seq_dimension=-3)
        q_out = torch.cat([q0.flatten(-3, -2), q1.flatten(-3, -2)], dim=-1)
        k_out = torch.cat([k0.flatten(-3, -2), k1.flatten(-3, -2)], dim=-1)
        if seq_dimension == -3:
            q_out, k_out = q_out.transpose(-3, -2), k_out.transpose(-3, -2)
        return q_out, k_out
