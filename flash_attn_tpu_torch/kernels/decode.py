"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` and its
plain-torch twin.

Replaces both TPU routes of ``flash_attn_tpu/kernels/decode.py``
(``_decode_kernel`` and ``_decode_dma_kernel``, launcher
``paged_decode_attention``) with one kernel. One query token per sequence
attends to a paged KV cache:

  q:          (batch, n_q_heads, d)
  k_pages:    (n_kv_heads, num_pages, page_size, d)
  lengths:    (batch,) int32 valid tokens per sequence
  page_table: (batch, pages_max) int32 physical page ids

Returns (batch, n_q_heads, d) in the q dtype. GQA: n_q_heads is a multiple
of n_kv_heads and each kv head serves its group of query heads.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    check_ported,
    paged_block_softmax,
    paged_visibility_mask,
)

HEAD_DIMS = (64, 128)
MAX_GROUP = 16  # query heads per kv head that one block serves


def paged_decode_attention(q, k_pages, v_pages, lengths, page_table, *,
                           softmax_scale: float | None = None,
                           k_scales=None, v_scales=None, window_left=None,
                           num_sinks: int = 0, alibi_slopes=None,
                           softcap=None):
    """Single-token decode against a paged bf16/fp16/fp32 KV cache. A CPU
    tensor takes the plain twin; a CUDA tensor launches the kernel or
    raises."""
    check_ported(k_scales=k_scales, v_scales=v_scales,
                 window_left=window_left, num_sinks=num_sinks or None,
                 alibi_slopes=alibi_slopes, softcap=softcap)
    batch, n_q_heads, d = q.shape
    n_kv_heads, num_pages, page_size, dk = k_pages.shape
    if dk != d or v_pages.shape != k_pages.shape or n_q_heads % n_kv_heads:
        raise ValueError(
            f"paged_decode_attention: shapes {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, page_table,
            softmax_scale=softmax_scale,
        )
    group = n_q_heads // n_kv_heads
    pages_max = page_table.shape[1]
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: head_dim {d} (need "
                         f"{HEAD_DIMS}), group {group} (max {MAX_GROUP})")
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32 \
            or lengths.shape != (batch,) or page_table.shape[0] != batch:
        raise ValueError("paged_decode_attention: lengths (batch,) and "
                         "page_table (batch, pages_max) must be int32")
    _build.require_cuda("paged_decode_attention", q, k_pages, v_pages,
                        lengths, page_table)
    out = torch.empty_like(q)
    lib = _build.lib()
    code = lib.fattn_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), page_table.data_ptr(), out.data_ptr(),
        batch, n_kv_heads, group, num_pages, page_size, pages_max, d,
        float(softmax_scale), _build.DTYPE_CODES[q.dtype],
        _build.stream_ptr(q.device),
    )
    paged_decode_attention.launches += 1
    _build.check(code, "fattn_paged_decode")
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_table, *,
                                 softmax_scale: float):
    """Plain-torch twin: walks the page table one page at a time with the
    shared online-softmax update (kernels/common.py), in fp32."""
    batch, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    qf = q.float().reshape(batch, n_kv_heads, group, d) * softmax_scale
    length = lengths.long().reshape(batch, 1, 1, 1)
    m = torch.full((batch, n_kv_heads, group, 1), DEFAULT_MASK_VALUE,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, n_kv_heads, group, d), device=q.device)
    for j in range(page_table.shape[1]):
        ids = page_table[:, j].long()
        k = k_pages[:, ids].float().transpose(0, 1)  # (b, h_kv, ps, d)
        v = v_pages[:, ids].float().transpose(0, 1)
        s = qf @ k.transpose(-1, -2)  # (b, h_kv, group, ps)
        kpos = j * page_size + torch.arange(page_size, device=q.device)
        mask = paged_visibility_mask(kpos, length - 1, length=length)
        p, alpha, m, l = paged_block_softmax(s, mask, m, l)
        acc = acc * alpha + p @ v
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.reshape(batch, n_q_heads, d).to(q.dtype)
