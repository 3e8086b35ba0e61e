"""Blocksparse attention modules (port of
``flash_attn_tpu/models/blocksparse_modules.py``).

``FlashBlocksparseAttention`` builds its sparsity layout once, at
``max_seq_length`` rounded up to 256, and cuts it to the sequence length,
with the compiled layout cached per (length, causal).
``sparsity_config`` is any object with ``make_layout(seqlen) -> (seqlen/16,
seqlen/256)`` 0/1 array, such as ``LocalGlobalSparsityConfig``, or a raw
mask. ``FlashBlocksparseMHA`` is ``Wqkv`` -> blocksparse attention ->
``out_proj``, named as in the flax tree. Dropout seeds come from a
``torch.Generator`` passed to ``forward``, as in ``models/modules.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from flash_attn_tpu_torch.kernels.blocksparse import COL_CELL, ROW_CELL
from flash_attn_tpu_torch.models.modules import draw_seeds, linear
from flash_attn_tpu_torch.ops.blocksparse import (
    blocksparse_attention,
    build_layout,
)


class LocalGlobalSparsityConfig:
    """Sliding-window + global-token cell layout (BigBird/Longformer
    style): cells within ``window`` positions of the diagonal, the first
    ``num_global_cols`` cell columns and the first ``num_global_rows`` cell
    rows."""

    def __init__(self, window: int = 512, num_global_cols: int = 1,
                 num_global_rows: int = 16):
        self.window = window
        self.num_global_cols = num_global_cols
        self.num_global_rows = num_global_rows

    def make_layout(self, seqlen: int) -> np.ndarray:
        nrow = (seqlen + ROW_CELL - 1) // ROW_CELL
        ncol = (seqlen + COL_CELL - 1) // COL_CELL
        rows = np.arange(nrow)[:, None] * ROW_CELL
        cols = np.arange(ncol)[None, :] * COL_CELL
        layout = np.abs(rows - cols) <= self.window
        layout[:, : self.num_global_cols] = True
        layout[: self.num_global_rows, :] = True
        return layout


class FlashBlocksparseAttention(nn.Module):
    """Inner blocksparse attention over packed qkv (b, s, 3, h, d)."""

    def __init__(self, sparsity_config: Any, softmax_temp: float | None = None,
                 attention_dropout: float = 0.0, max_seq_length: int = 2048,
                 block_q: int = 128):
        super().__init__()
        self.sparsity_config = sparsity_config
        self.softmax_temp = softmax_temp
        self.attention_dropout = attention_dropout
        self.max_seq_length = max_seq_length
        self.block_q = block_q
        max_s = ((max_seq_length + 255) // 256) * 256
        sc = sparsity_config
        self._mask = np.asarray(sc.make_layout(max_s) if hasattr(
            sc, "make_layout") else sc).astype(bool)
        self._layouts = {}  # (s, causal) -> layout

    def layout(self, s: int, causal: bool):
        """The compiled layout for sequence length ``s`` (cached)."""
        key = (s, causal)
        if key not in self._layouts:
            s_rounded = ((s + 255) // 256) * 256
            nrow, ncol = s_rounded // ROW_CELL, s_rounded // COL_CELL
            if nrow > self._mask.shape[0] or ncol > self._mask.shape[1]:
                raise ValueError(f"seqlen {s} exceeds max_seq_length "
                                 f"{self.max_seq_length}")
            self._layouts[key] = build_layout(
                self._mask[:nrow, :ncol], sq=s, sk=s, block_q=self.block_q,
                causal=causal)
        return self._layouts[key]

    def forward(self, qkv, key_padding_mask=None, causal: bool = False,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        if qkv.dim() != 5 or qkv.shape[2] != 3:
            raise ValueError(f"qkv must be (b, s, 3, h, d), got "
                             f"{tuple(qkv.shape)}")
        dropout_p = 0.0 if deterministic else self.attention_dropout
        seed = draw_seeds(generator, 1)[0] if dropout_p > 0.0 else None
        q, k, v = qkv.unbind(dim=2)
        return blocksparse_attention(
            q, k, v, self.layout(qkv.shape[1], causal), causal=causal,
            softmax_scale=self.softmax_temp,
            key_padding_mask=key_padding_mask, dropout_p=dropout_p,
            dropout_seed=seed, block_q=self.block_q)


class FlashBlocksparseMHA(nn.Module):
    """MHA block with blocksparse inner attention: fused ``Wqkv`` ->
    ``inner_attn`` -> ``out_proj``. ``dtype`` is the compute dtype (None:
    the promotion of the input's and the parameters'); the parameters are
    stored in ``param_dtype`` on ``device`` (the card unless told
    otherwise)."""

    def __init__(self, embed_dim: int, num_heads: int, sparsity_config: Any,
                 bias: bool = True, attention_dropout: float = 0.0,
                 causal: bool = False, max_seq_length: int = 2048,
                 dtype=None, param_dtype=torch.float32, device="cuda"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.dtype = dtype
        factory = dict(device=device, dtype=param_dtype)
        self.Wqkv = nn.Linear(embed_dim, 3 * embed_dim, bias=bias, **factory)
        self.inner_attn = FlashBlocksparseAttention(
            sparsity_config, attention_dropout=attention_dropout,
            max_seq_length=max_seq_length)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias, **factory)

    def forward(self, x, key_padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        b, s, _ = x.shape
        dtype = self.dtype if self.dtype is not None else \
            torch.promote_types(x.dtype, self.Wqkv.weight.dtype)
        qkv = linear(x, self.Wqkv, dtype).reshape(b, s, 3, self.num_heads,
                                                  self.head_dim)
        ctx = self.inner_attn(qkv, key_padding_mask=key_padding_mask,
                              causal=self.causal,
                              deterministic=deterministic,
                              generator=generator)
        return linear(ctx.reshape(b, s, self.embed_dim), self.out_proj, dtype)
