"""``flash_attn_with_kvcache``: fused append + attend for serving (port of
``flash_attn_tpu/serving/kvcache.py``).

Write this step's K/V into the paged cache and attend the query chunk
against the whole cache, tail-aligned, in one launch of the multi-token
paged kernel (K6, ``kernels/chunk.py``), which appends as the span-append
kernel (K7b, ``serving/cache.py`` ``append_span``) would before it reads.
The cache is updated in place and returned, so call sites read as in the
JAX package.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels.chunk import (
    append_fits,
    paged_chunk_attention,
)
from flash_attn_tpu_torch.kernels.common import check_ported
from flash_attn_tpu_torch.ops.rotary import apply_rotary_at_positions
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
    speculative verification and chunked prefill. q, k and v may be views
    of a fused projection.

    With k/v, a chunk that is one row tile of K6's block (``append_fits``:
    sq * group <= 128, fp32 64; verification) is appended inside K6's
    launch. A longer chunk, on the card, is appended by one K7b launch and
    then attended by K6, counted in
    ``flash_attn_with_kvcache.split_appends``: a choice by shape, the same
    result either way.

    ``apply_rotary=True`` rotates q (and the new k, when given) at their
    global cache positions before the write and the attention
    (``ops/rotary.py`` ``apply_rotary_at_positions``, base
    ``rotary_base``): the upstream in-place rotary convention, for models
    whose cache holds post-rotary keys.

    ``window_left``, ``alibi_slopes`` ((n_q_heads,)) and ``softcap`` follow
    ``paged_chunk_attention`` (global cache positions). ``qk_quant`` (M8)
    is not ported: it raises before the cache is touched.
    """
    check_ported(qk_quant=qk_quant)
    if (k is None) != (v is None):
        raise ValueError("k and v must be given together")
    batch, sq = q.shape[:2]
    if new_lens is None:
        new_lens = torch.full((batch,), sq, dtype=torch.int32,
                              device=q.device)
    new_lens = new_lens.to(torch.int32)
    cache_seqlens = cache_seqlens.to(torch.int32)
    if apply_rotary:
        # Chunk row t sits at global position total - chunk + t: with k/v
        # cache_seqlens + t (padding rows past new_lens get positions too;
        # they are neither written nor output).
        base = cache_seqlens if k is not None else cache_seqlens - new_lens
        pos = (base[:, None] + torch.arange(sq, dtype=torch.int32,
                                            device=q.device)).clamp(min=0)
        q = apply_rotary_at_positions(q, pos[:, :, None], base=rotary_base)
        if k is not None:
            k = apply_rotary_at_positions(k, pos[:, :, None],
                                          base=rotary_base)
    total, new = cache_seqlens, {}
    if k is not None:
        total = cache_seqlens + new_lens
        group = q.shape[2] // cache.k_pages.shape[0]
        if q.device.type == "cpu" or append_fits(sq, group, q.dtype):
            new = dict(new_k=k, new_v=v, cache_seqlens=cache_seqlens)
        else:
            append_chunk(cache, k, v, page_table, cache_seqlens, new_lens)
            flash_attn_with_kvcache.split_appends += 1
    out = paged_chunk_attention(
        q, cache.k_pages, cache.v_pages, total, page_table,
        chunk_lens=new_lens, softmax_scale=softmax_scale,
        window_left=window_left, alibi_slopes=alibi_slopes, softcap=softcap,
        qk_quant=qk_quant, **new)
    return out, cache


flash_attn_with_kvcache.split_appends = 0
