"""Plain-torch twins of the shared paged-kernel algebra of
``flash_attn_tpu/kernels/common.py`` (mask and online-softmax update).

The CUDA kernels carry the same algebra inline; these functions are the
plain path the CPU tests run and the kernels are compared with.
"""

from __future__ import annotations

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def paged_visibility_mask(kpos, qpos, *, length):
    """(rows, bk) True = key visible: in-sequence and causal against the
    row's query position. ``qpos`` and ``length`` may be scalars or tensors
    that broadcast against ``kpos`` (common.py:266; the window and sink
    terms are ROADMAP port item P2)."""
    return (kpos < length) & (kpos <= qpos)


def paged_block_softmax(s, mask, m_prev, l_prev):
    """Masked online-softmax update of one key block (common.py:281).

    ``s``: (..., bk) fp32 scaled scores; ``m_prev``/``l_prev``: (..., 1)
    running max and sum. Returns ``(p, alpha, m_next, l_next)``; the caller
    rescales its accumulator by ``alpha`` and adds ``p @ v``.
    """
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m_next = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_prev - m_next)
    p = torch.where(mask, torch.exp(s - m_next), 0.0)
    l_next = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    return p, alpha, m_next, l_next
