"""What the kernels' wrappers share.

- Plain-torch twins of the shared paged-kernel algebra of
  ``flash_attn_tpu/kernels/common.py`` (block liveness, mask and
  online-softmax update). The CUDA kernels K5 and K6 share the same
  predicates in ``csrc/paged.cuh``; these functions are the plain path the
  CPU tests run and the kernels are compared with.
- The strided operands of the attention kernels K1, K2 and K8a-c
  (``csrc/common.cuh`` ``Strides``): a (b, h, s, d) operand is taken in
  place when its last dimension is contiguous and every row starts on a
  16-byte boundary (``rows_ok``), so the ops hand over transposed views of
  their (b, s, h, d) tensors and of a packed qkv; outputs are (b, h, s, d)
  views of (b, s, h, d) memory (``empty_rows``).
"""

from __future__ import annotations

import ctypes

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_UNPORTED = {
    "k_scales": "P3 (quantized KV)", "v_scales": "P3 (quantized KV)",
    "window_left": "P2 (window in K5/K6)",
    "num_sinks": "P2 (window in K5/K6)",
    "alibi_slopes": "P2 (ALiBi/softcap)", "softcap": "P2 (ALiBi/softcap)",
    "qk_quant": "P11 (int8 QK, K9)",
}


def check_ported(**given):
    """Raise for an argument of the paged kernels' JAX signatures that the
    port does not run yet (any value but None), naming the ROADMAP port
    item that brings it."""
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}: ROADMAP port item {_UNPORTED[name]}")


def paged_block_live(j, bk, *, length, window_left=None,
                     first_band_pos=None):
    """Liveness of key block ``j`` (width ``bk``) for the paged kernels
    (common.py:245): some key of it is in-sequence. ``length`` may be a
    tensor. The window band and sinks are ROADMAP port item P2."""
    if window_left is not None or first_band_pos is not None:
        raise NotImplementedError(
            "paged_block_live(window_left=...): ROADMAP port item P2 "
            "(window in K5/K6)")
    return j * bk < length


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


# The attention kernels' operands, in the order of csrc/common.cuh Operand.
OPERANDS = ("q", "k", "v", "o", "dout", "dk", "dv", "dq")


def rows_ok(x: torch.Tensor) -> bool:
    """The kernels read or write a (b, h, s, d) operand in place: its last
    dimension is contiguous and every row starts on a 16-byte boundary."""
    size = x.element_size()
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels take it in place, else a copy."""
    return x if rows_ok(x) else x.contiguous()


def check_rows(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless the kernels can take every tensor in place."""
    for x in tensors:
        if not rows_ok(x):
            raise ValueError(
                f"{name}: a tensor of strides {x.stride()} needs a contiguous "
                "last dimension and 16-byte aligned rows (the kernels load "
                "16-byte vectors and TMA boxes); pass kernel_operand(x)")


def empty_rows(b, h, s, like):
    """A (b, h, s, d) output in (b, s, h, d) memory: the ops transpose it
    back to their own layout without a copy."""
    return torch.empty((b, s, h, like.shape[-1]), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def strides_arg(**operands):
    """The (batch, head, row) element strides of each of ``OPERANDS`` as
    the C entry points take them; 0 for an operand the kernel does not
    use."""
    flat = []
    for name in OPERANDS:
        x = operands.get(name)
        flat += [0, 0, 0] if x is None else list(x.stride()[:3])
    return (ctypes.c_longlong * len(flat))(*flat)
