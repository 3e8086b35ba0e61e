"""``flash_attn_with_kvcache``: fused append + attend for serving (port of
``flash_attn_tpu/serving/kvcache.py``).

Write this step's K/V into the paged cache with the span-append kernel
(K7b, ``serving/cache.py`` ``append_span``), then attend the query chunk
against the whole cache with the multi-token paged kernel (K6,
``kernels/chunk.py``), tail-aligned. The cache is updated in place and
returned, so call sites read as in the JAX package.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
from flash_attn_tpu_torch.kernels.common import check_ported
from flash_attn_tpu_torch.serving.cache import PagedKVCache, append_span


def append_chunk(cache: PagedKVCache, new_k, new_v, page_table, lengths,
                 new_lens=None) -> PagedKVCache:
    """Append up to ``sq`` tokens per sequence (batch, sq, n_kv_heads, d)
    to the paged cache: row t of sequence b lands at position ``lengths[b] +
    t`` when ``t < new_lens[b]``; padding and inactive rows write nothing.
    The pages must already be allocated (``PageAllocator.extend``)."""
    return append_span(cache, new_k, new_v, page_table, lengths, new_lens)


def flash_attn_with_kvcache(q, cache: PagedKVCache, page_table,
                            cache_seqlens, k=None, v=None, *, new_lens=None,
                            softmax_scale: float | None = None,
                            window_left=None, alibi_slopes=None,
                            softcap=None, apply_rotary: bool = False,
                            rotary_base: float = 10000.0, qk_quant=None):
    """Returns ``(out, cache)``: attention of the query chunk q (batch, sq,
    n_q_heads, d) against the cache, and the cache with this step's K/V
    written.

    Tail-aligned causality: query row t sits at global position
    ``total[b] - new_lens[b] + t``, with ``total = cache_seqlens +
    new_lens`` when k/v (batch, sq, n_kv_heads, d) are given (they are
    appended first) and ``total = cache_seqlens`` when they are not (the
    chunk's K/V must then already be cached). ``new_lens`` (batch,) marks
    the valid chunk rows (default sq); the rest are padding: not written,
    output zero. One call with sq=1 is a decode step; sq>1 covers
    speculative verification and chunked prefill.

    ``apply_rotary`` needs ``ops/rotary.py`` (ROADMAP port item P6);
    ``window_left``, ``alibi_slopes``, ``softcap`` (P2) and ``qk_quant``
    (P11) are not ported either. Each raises before the cache is touched.
    """
    if apply_rotary:
        raise NotImplementedError(
            "apply_rotary: apply_rotary_at_positions (ops/rotary.py) is "
            "ROADMAP port item P6")
    check_ported(window_left=window_left, alibi_slopes=alibi_slopes,
                 softcap=softcap, qk_quant=qk_quant)
    if (k is None) != (v is None):
        raise ValueError("k and v must be given together")
    batch, sq = q.shape[:2]
    if new_lens is None:
        new_lens = torch.full((batch,), sq, dtype=torch.int32,
                              device=q.device)
    new_lens = new_lens.to(torch.int32)
    cache_seqlens = cache_seqlens.to(torch.int32)
    if k is not None:
        cache = append_chunk(cache, k, v, page_table, cache_seqlens,
                             new_lens)
        total = cache_seqlens + new_lens
    else:
        total = cache_seqlens
    out = paged_chunk_attention(
        q, cache.k_pages, cache.v_pages, total, page_table,
        chunk_lens=new_lens, softmax_scale=softmax_scale,
        window_left=window_left, alibi_slopes=alibi_slopes, softcap=softcap,
        qk_quant=qk_quant)
    return out, cache
