"""Multi-token paged attention: the CUDA kernel ``csrc/paged_chunk.cu`` and
its plain-torch twin.

Replaces ``flash_attn_tpu/kernels/chunk.py`` ``_chunk_kernel`` (launcher
``paged_chunk_attention``): a chunk of ``sq`` query tokens per sequence
attends to the paged KV cache, the compute core of chunked prefill and of
speculative verification.

  q:          (batch, sq, n_q_heads, d)
  k_pages:    (n_kv_heads, num_pages, page_size, d)
  lengths:    (batch,) int32 total cached tokens INCLUDING the chunk
  chunk_lens: (batch,) int32 valid chunk rows (<= sq; the rest is padding)
  page_table: (batch, pages_max) int32 physical page ids

Query row t of sequence b sits at global position ``lengths[b] -
chunk_lens[b] + t`` (tail-aligned: the chunk is the end of the cached
sequence, whose K/V must already be written) and sees the keys at or before
it. Rows t >= chunk_lens[b], and rows that see no key, give 0. Returns
(batch, sq, n_q_heads, d) in the q dtype. GQA: each kv head serves its group
of query heads. q may be any view whose last dimension is contiguous and
whose rows start on 16-byte boundaries (the models pass a slice of their
fused projection); the pages must be contiguous and, for bf16/fp16, their
page size a multiple of 64 or a divisor of 64 from 8 on (the kernel's TMA
boxes). On the card a small grid has its keys split over
``paged_num_splits`` blocks, merged in order by a second launch (bf16 and
fp16; fp32 runs unsplit), so the result is bitwise reproducible.

``window_left`` (row t sees keys [qpos_t - window_left, qpos_t]),
``alibi_slopes`` ((n_q_heads,): bias slope * (kpos - qpos)) and ``softcap``
follow the JAX launcher (chunk.py:215-283; global cache positions). Sinks
are decode-only (``paged_decode_attention``), as in JAX. On the card a block
walks the band from its first row's floor only.

With ``new_k``, ``new_v`` (batch, sq, n_kv_heads, d) and ``cache_seqlens``
(batch,) int32 the launch first appends the chunk's K/V IN PLACE, as
``serving/cache.py`` ``append_span(cache, new_k, new_v, page_table,
cache_seqlens, chunk_lens)`` writes them (row t at position
``cache_seqlens[b] + t`` for t < chunk_lens[b]; nothing for an inactive
sequence or past the table), with ``lengths = cache_seqlens + chunk_lens``:
the output and the cache are bit for bit what that append followed by this
kernel give. On the card this form takes one row tile (``append_fits``:
sq * group <= 128, fp32 64), the verification shape; a longer chunk
raises, and ``flash_attn_with_kvcache`` then appends by ``append_span``
first.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    SPLIT_TILE,
    check_ported,
    kernel_operand,
    paged_block_live,
    paged_block_softmax,
    paged_live_pages,
    paged_live_span,
    paged_num_splits,
    paged_split_keys,
    paged_terms,
    paged_visibility_mask,
    sm_count,
)
from flash_attn_tpu_torch.serving.cache import (
    PagedKVCache,
    append_span_plain,
    new_rows,
)

HEAD_DIMS = (64, 128)
MAX_GROUP = 64  # query heads per kv head a block holds
BLOCK_ROWS = 128  # query rows per block of the bf16/fp16 kernel
F32_BLOCK_ROWS = 64  # and of the fp32 kernel


def page_size_ok(page_size: int) -> bool:
    """The bf16/fp16 kernel's 64-key tiles are whole TMA boxes of one
    page: page sizes that are multiples of 64 or divisors of 64 from 8 on."""
    return page_size % SPLIT_TILE == 0 or (
        SPLIT_TILE % page_size == 0 and page_size >= 8)


def append_fits(sq: int, group: int, dtype) -> bool:
    """The kernel appends inside its launch when the chunk is one row
    tile of its block: sq * group query rows within the block's rows (128,
    fp32 64). Only then does one block read each new key."""
    rows = F32_BLOCK_ROWS if dtype == torch.float32 else BLOCK_ROWS
    return sq * group <= rows


def paged_chunk_attention(q, k_pages, v_pages, lengths, page_table,
                          k_scales=None, v_scales=None, *, chunk_lens=None,
                          softmax_scale: float | None = None,
                          window_left=None, alibi_slopes=None, softcap=None,
                          qk_quant=None, new_k=None, new_v=None,
                          cache_seqlens=None):
    """Chunk-of-queries attention against a paged bf16/fp16/fp32 KV cache,
    with the chunk's K/V appended first when ``new_k``/``new_v`` and
    ``cache_seqlens`` are given (module docstring). A CPU tensor takes the
    plain twins; a CUDA tensor launches the kernel or raises."""
    check_ported(k_scales=k_scales, v_scales=v_scales, qk_quant=qk_quant)
    window_left, _, slopes, softcap = terms = paged_terms(
        "paged_chunk_attention", q.shape[2], window_left=window_left,
        num_sinks=0, alibi_slopes=alibi_slopes, softcap=softcap,
        device=q.device)
    batch, sq, n_q_heads, d = q.shape
    n_kv_heads, num_pages, page_size, dk = k_pages.shape
    if dk != d or v_pages.shape != k_pages.shape or n_q_heads % n_kv_heads:
        raise ValueError(
            f"paged_chunk_attention: shapes {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if chunk_lens is None:
        chunk_lens = torch.full((batch,), sq, dtype=torch.int32,
                                device=q.device)
    new = (new_k, new_v, cache_seqlens)
    if any(x is None for x in new) != all(x is None for x in new):
        raise ValueError("paged_chunk_attention: new_k, new_v and "
                         "cache_seqlens go together")
    if new_k is not None:
        if new_k.shape != (batch, sq, n_kv_heads, d) \
                or new_v.shape != new_k.shape:
            raise ValueError(f"paged_chunk_attention: new_k "
                             f"{tuple(new_k.shape)}, new_v "
                             f"{tuple(new_v.shape)} for q {tuple(q.shape)}")
        for t in (new_k, new_v):
            if t.dtype != k_pages.dtype:
                raise ValueError(f"paged_chunk_attention: payload {t.dtype} "
                                 f"into a {k_pages.dtype} cache")
    if q.device.type == "cpu":
        if new_k is not None:
            append_span_plain(PagedKVCache(k_pages, v_pages), new_k, new_v,
                              page_table, cache_seqlens, chunk_lens)
        return paged_chunk_attention_plain(
            q, k_pages, v_pages, lengths, page_table, chunk_lens=chunk_lens,
            softmax_scale=softmax_scale, terms=terms)
    group = n_q_heads // n_kv_heads
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_chunk_attention: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"paged_chunk_attention: head_dim {d} (need "
                         f"{HEAD_DIMS}), group {group} (max {MAX_GROUP})")
    ints = [("lengths", lengths), ("chunk_lens", chunk_lens)]
    nk = (None, None, None, 0, 0, 0)
    if new_k is not None:
        if not append_fits(sq, group, q.dtype):
            raise ValueError(f"paged_chunk_attention: the append runs inside "
                             f"the launch for one row tile only (sq {sq} x "
                             f"group {group} > {BLOCK_ROWS}, fp32 "
                             f"{F32_BLOCK_ROWS}); append with append_span "
                             "first")
        ints.append(("cache_seqlens", cache_seqlens))
        _build.require_device("paged_chunk_attention", new_k, new_v, q)
        nk = (new_k.data_ptr(), new_v.data_ptr(), cache_seqlens.data_ptr(),
              *new_rows("paged_chunk_attention", new_k, new_v,
                        PagedKVCache(k_pages, v_pages)))
    for name, t in ints:
        if t.dtype != torch.int32 or t.shape != (batch,):
            raise ValueError(f"paged_chunk_attention: {name} must be int32 "
                             f"of shape {(batch,)}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != batch:
        raise ValueError("paged_chunk_attention: page_table must be int32 "
                         "(batch, pages_max)")
    _build.require_device("paged_chunk_attention", q, k_pages, v_pages,
                          lengths, chunk_lens, page_table)
    _build.require_cuda("paged_chunk_attention", k_pages, v_pages,
                        page_table, *(t for _, t in ints))
    if any(x.data_ptr() % 16 for x in (k_pages, v_pages)):
        raise ValueError("paged_chunk_attention: the pages must be 16-byte "
                         "aligned (the kernel loads 16-byte vectors)")
    f32 = q.dtype == torch.float32
    if not f32 and not page_size_ok(page_size):
        raise ValueError(f"paged_chunk_attention: page_size {page_size} (the "
                         "bf16/fp16 kernel needs a multiple of 64 or a "
                         "divisor of 64 from 8 on)")
    q = kernel_operand(q)
    pages_max = page_table.shape[1]
    out = torch.empty((batch, sq, n_q_heads, d), dtype=q.dtype,
                      device=q.device)
    n_splits, partials = 1, None
    # The splits cut the walk: the band of the chunk's rows (all of the
    # table without a window).
    live = paged_live_span(pages_max, page_size, window_left, 0, sq)
    if not f32:
        row_tiles = -(-sq // (BLOCK_ROWS // group))
        n_splits = paged_num_splits(batch * row_tiles, n_kv_heads, pages_max,
                                    page_size, sm_count(q.device.index), live)
    if n_splits > 1:
        partials = torch.empty(n_splits * batch * sq * n_q_heads * (d + 1),
                               dtype=torch.float32, device=q.device)
    code = _build.lib().fattn_paged_chunk(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
        chunk_lens.data_ptr(), page_table.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(), *nk, batch, sq,
        n_kv_heads, group, num_pages, page_size, pages_max, n_splits,
        paged_split_keys(paged_live_pages(pages_max, page_size, live),
                         page_size, n_splits), d,
        float(softmax_scale), -1 if window_left is None else window_left,
        0.0 if softcap is None else softcap,
        None if slopes is None else slopes.data_ptr(),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(code, "fattn_paged_chunk")
    paged_chunk_attention.launches += 1
    paged_chunk_attention.append_launches += int(new_k is not None)
    return out


_build.counter(paged_chunk_attention)  # every launch
# those that appended first
_build.counter(paged_chunk_attention, "append_launches")


def paged_chunk_attention_plain(q, k_pages, v_pages, lengths, page_table, *,
                                chunk_lens, softmax_scale: float,
                                terms=(None, 0, None, None)):
    """Plain-torch twin: walks the page table one page at a time, skipping
    pages no sequence has live (``paged_block_live``, from the first row's
    band floor), with the shared mask and online-softmax update
    (kernels/common.py), in fp32. ``terms``: (window_left, 0, slopes,
    softcap) from ``paged_terms``. Keys no row sees are zeroed before the
    products, as the kernels never read them."""
    window_left, _, slopes, softcap = terms
    batch, sq, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    dev = q.device
    # (b, sq, hq, d) -> (b, h_kv, group, sq, d): rows of one kv head
    qf = (q.float() * softmax_scale).reshape(
        batch, sq, n_kv_heads, group, d).permute(0, 2, 3, 1, 4)
    length = lengths.long().reshape(batch, 1, 1, 1, 1)
    chunk = chunk_lens.long().reshape(batch, 1, 1, 1, 1)
    t = torch.arange(sq, device=dev).reshape(1, 1, 1, sq, 1)
    # Padding rows get position -1: they see no key.
    qpos = torch.where(t < chunk, length - chunk + t, -1)
    alibi_col = None if slopes is None else slopes.reshape(
        1, n_kv_heads, group, 1, 1)
    first_qpos = (lengths - chunk_lens).long()
    m = torch.full((batch, n_kv_heads, group, sq, 1), DEFAULT_MASK_VALUE,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, n_kv_heads, group, sq, d), device=dev)
    for j in range(page_table.shape[1]):
        live = paged_block_live(
            j, page_size, length=lengths, window_left=window_left,
            first_band_pos=first_qpos - (window_left or 0))
        if not bool(live.any()):
            continue
        ids = page_table[:, j].long()
        kpos = j * page_size + torch.arange(page_size, device=dev)
        mask = paged_visibility_mask(kpos, qpos, length=length,
                                     window_left=window_left)
        seen = mask.any(dim=-2)[:, :, :1, :, None]  # (b, 1, 1, ps, 1)
        k = k_pages[:, ids].float().transpose(0, 1)[:, :, None]
        v = v_pages[:, ids].float().transpose(0, 1)[:, :, None]
        k, v = (torch.where(seen, x, 0.0) for x in (k, v))
        s = qf @ k.transpose(-1, -2)  # (b, h_kv, group, sq, ps)
        p, alpha, m, l = paged_block_softmax(
            s, mask, m, l, softcap=softcap, alibi_col=alibi_col,
            rel=None if slopes is None else (kpos - qpos).float())
        acc = acc * alpha + p @ v
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.permute(0, 3, 1, 2, 4).reshape(
        batch, sq, n_q_heads, d).to(q.dtype)
