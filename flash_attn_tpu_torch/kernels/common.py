"""What the kernels' wrappers share.

- Plain-torch twins of the shared paged-kernel algebra of
  ``flash_attn_tpu/kernels/common.py`` (block liveness, mask and
  online-softmax update). The CUDA kernels K5 and K6 share the same
  predicates in ``csrc/paged.cuh``; these functions are the plain path the
  CPU tests run and the kernels are compared with.
- Split-KV, shared by K5 and K6 (``csrc/paged_split.cuh``): the host's
  choice of the split count from shapes alone (``paged_num_splits``,
  ``paged_split_keys``), the merge of partials (``merge_partials``, the
  counterpart of ``flash_attn_tpu/parallel/ring.py`` ``_merge_partials``)
  and the split algorithm in plain torch (``paged_split_plain``).
- The strided operands of the attention kernels K1, K2 and K8a-c
  (``csrc/common.cuh`` ``Strides``): a (b, h, s, d) operand is taken in
  place when its last dimension is contiguous and every row starts on a
  16-byte boundary (``rows_ok``), so the ops hand over transposed views of
  their (b, s, h, d) tensors and of a packed qkv; outputs are (b, h, s, d)
  views of (b, s, h, d) memory (``empty_rows``).
"""

from __future__ import annotations

import ctypes
import functools
import math

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


# A split holds whole 64-key tiles (K6's tile) of whole pages.
SPLIT_TILE = 64


def paged_split_keys(pages_max: int, page_size: int, n_splits: int) -> int:
    """Keys per split when ``n_splits`` ranges share a table of
    ``pages_max`` pages: whole pages, a multiple of SPLIT_TILE keys."""
    unit = math.lcm(page_size, SPLIT_TILE)
    return -(-(-(-pages_max // n_splits) * page_size) // unit) * unit


def paged_num_splits(batch: int, h_kv: int, pages_max: int, page_size: int,
                     n_sm: int) -> int:
    """How many key ranges the paged kernels cut each sequence into: the
    most that keep ``batch * h_kv`` blocks per range within two waves of
    ``n_sm`` SMs, at least 1 and never a range without a page. A function
    of shapes only: the lengths live on the card, and reading them would
    synchronise every layer of every step. (``batch`` counts every block
    row of a sequence: K6 passes batch x row tiles.)"""
    n = max(1, min(pages_max, 2 * n_sm // max(1, batch * h_kv)))
    return -(-pages_max * page_size // paged_split_keys(pages_max, page_size,
                                                        n))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (cached: asked once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _weighted(o, lse, lse_new):
    """o * exp(lse - lse_new), exactly 0 where lse = -inf whatever o
    holds (exp(-inf - -inf) would be NaN)."""
    return torch.where(torch.isneginf(lse)[..., None], 0.0,
                       o * torch.exp(lse - lse_new)[..., None])


def merge_partials(o, lse):
    """Merge attention partials in order: ``o`` (n, ..., d) each normalised
    by its own sum, ``lse`` (n, ...) their log-sum-exps (natural log). A
    fully masked partial (lse = -inf) contributes exactly 0. Returns the
    merged (o fp32, lse); o is 0 where every lse is -inf. Pairwise from the
    first partial on, as ``flash_attn_tpu/parallel/ring.py``
    ``_merge_partials``."""
    lse = lse.float()
    acc, acc_lse = _weighted(o[0].float(), lse[0], lse[0]), lse[0]
    for o_b, lse_b in zip(o[1:], lse[1:]):
        lse_new = torch.logaddexp(acc_lse, lse_b)
        acc = _weighted(acc, acc_lse, lse_new) + _weighted(
            o_b.float(), lse_b, lse_new)
        acc_lse = lse_new
    return acc, acc_lse


def paged_split_plain(q, k_pages, v_pages, lengths, page_table, *,
                      chunk_lens, softmax_scale: float, n_splits: int):
    """The kernels' split-KV algorithm in plain torch, fp32: each of
    ``n_splits`` key ranges (``paged_split_keys`` keys, whole pages) gives
    every row a partial (o normalised by its own sum, lse), and
    ``merge_partials`` combines them in split order. q (b, sq, h, d) with
    tail-aligned rows as ``paged_chunk_attention``; padding rows and rows
    that see no key give 0. Returns (b, sq, h, d) fp32."""
    batch, sq, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    pages_max = page_table.shape[1]
    group = n_q_heads // n_kv_heads
    dev = q.device
    qf = (q.float() * softmax_scale).reshape(
        batch, sq, n_kv_heads, group, d).permute(0, 2, 3, 1, 4)
    length = lengths.long().clamp(0, pages_max * page_size).reshape(
        batch, 1, 1, 1, 1)
    chunk = chunk_lens.long().reshape(batch, 1, 1, 1, 1)
    t = torch.arange(sq, device=dev).reshape(1, 1, 1, sq, 1)
    qpos = torch.where(t < chunk, lengths.long().reshape(
        batch, 1, 1, 1, 1) - chunk + t, -1)
    keys = paged_split_keys(pages_max, page_size, n_splits)
    # Every key position of the table, gathered once: (b, h_kv, keys, d).
    ids = page_table.long()
    k_all = k_pages[:, ids].float().permute(1, 0, 2, 3, 4).reshape(
        batch, n_kv_heads, pages_max * page_size, d)
    v_all = v_pages[:, ids].float().permute(1, 0, 2, 3, 4).reshape(
        batch, n_kv_heads, pages_max * page_size, d)
    outs, lses = [], []
    for s in range(n_splits):
        lo, hi = s * keys, min((s + 1) * keys, pages_max * page_size)
        kpos = torch.arange(lo, max(lo, hi), device=dev)
        sc = qf @ k_all[:, :, None, lo:hi].transpose(-1, -2)
        mask = paged_visibility_mask(kpos, qpos, length=length)
        sc = torch.where(mask, sc, float("-inf"))
        lse = torch.logsumexp(sc, dim=-1)  # -inf where nothing is visible
        p = torch.where(mask, torch.exp(sc - torch.where(
            torch.isneginf(lse), 0.0, lse)[..., None]), 0.0)
        outs.append(p @ v_all[:, :, None, lo:hi])
        lses.append(lse)
    out, _ = merge_partials(torch.stack(outs), torch.stack(lses))
    return out.permute(0, 3, 1, 2, 4).reshape(batch, sq, n_q_heads, d)


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
