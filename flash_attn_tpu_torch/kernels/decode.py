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
of n_kv_heads and each kv head serves its group of query heads. q may be
any view whose last dimension is contiguous (the models pass a slice of
their fused projection); the pages must be contiguous. On the card the
keys are split over ``paged_num_splits`` blocks per (sequence, kv head),
chosen from the shapes and the SM count (the lengths stay on the card),
and a second launch merges the splits in order: at most two launches and
one scratch allocation per call, and a bitwise reproducible result.

``window_left`` (the query sees keys [length - 1 - window_left, length)),
``num_sinks`` (with a window, the first positions stay visible:
StreamingLLM), ``alibi_slopes`` ((n_q_heads,): bias slope * (kpos - qpos))
and ``softcap`` (on the scaled scores, before the bias) follow the JAX
launcher (decode.py:474-536). On the card the splits cut the band and the
sink pages, not the table: pages wholly below the band are never fetched.

``paged_decode_with_append`` is the serving decode step's form: it writes
this step's K/V row into the cache inside the same launch (K7a's slot,
``serving/cache.py`` ``append_token``) and attends over the cache with it,
bit for bit what ``append_token`` followed by ``paged_decode_attention``
give, with one launch fewer.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    check_ported,
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
    append_token_plain,
    new_rows,
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
    check_ported(k_scales=k_scales, v_scales=v_scales)
    terms = paged_terms("paged_decode_attention", q.shape[1],
                        window_left=window_left, num_sinks=num_sinks,
                        alibi_slopes=alibi_slopes, softcap=softcap,
                        device=q.device)
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        _check_shapes("paged_decode_attention", q, k_pages, v_pages)
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, page_table,
            softmax_scale=softmax_scale, terms=terms,
        )
    out = _launch("paged_decode_attention", q, k_pages, v_pages, lengths,
                  page_table, softmax_scale, None, terms)
    paged_decode_attention.launches += 1
    return out


_build.counter(paged_decode_attention)


def paged_decode_with_append(q, new_k, new_v, k_pages, v_pages,
                             cache_lengths, page_table, *,
                             softmax_scale: float | None = None,
                             window_left=None, num_sinks: int = 0,
                             alibi_slopes=None, softcap=None):
    """One decode step's append and attention in one launch: new_k/new_v
    (batch, n_kv_heads, d) go to each sequence's next slot IN PLACE, as
    ``append_token(PagedKVCache(k_pages, v_pages), new_k, new_v,
    page_table, cache_lengths)`` writes them (an inactive slot, length < 0,
    to the scratch page 0), and q attends over ``max(cache_lengths, 0) +
    1`` keys with the new one, as ``paged_decode_attention`` does. Returns
    what that pair returns, and leaves the cache as it leaves it (bit for
    bit on the card; page 0 aside). ``cache_lengths`` (batch,) int32 are
    the lengths BEFORE the append. new_k/new_v may be views of a fused
    projection (``serving/cache.py`` ``new_rows``). An inactive slot's
    output is not defined beyond that pair's (it may read page 0 while
    other slots write it); the engine discards it. The M4 terms are
    ``paged_decode_attention``'s. A CPU tensor takes the pair of plain
    twins; a CUDA tensor launches the kernel or raises."""
    terms = paged_terms("paged_decode_with_append", q.shape[1],
                        window_left=window_left, num_sinks=num_sinks,
                        alibi_slopes=alibi_slopes, softcap=softcap,
                        device=q.device)
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if new_k.shape != (q.shape[0], k_pages.shape[0], q.shape[-1]) \
            or new_v.shape != new_k.shape:
        raise ValueError(f"paged_decode_with_append: new_k "
                         f"{tuple(new_k.shape)}, new_v {tuple(new_v.shape)}"
                         f" for q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    for t in (new_k, new_v):
        if t.dtype != k_pages.dtype:
            raise ValueError(f"paged_decode_with_append: payload {t.dtype} "
                             f"into a {k_pages.dtype} cache")
    if q.device.type == "cpu":
        _check_shapes("paged_decode_with_append", q, k_pages, v_pages)
        append_token_plain(PagedKVCache(k_pages, v_pages), new_k, new_v,
                           page_table, cache_lengths)
        return paged_decode_attention_plain(
            q, k_pages, v_pages,
            (cache_lengths.clamp(min=0) + 1).to(torch.int32), page_table,
            softmax_scale=softmax_scale, terms=terms)
    out = _launch("paged_decode_with_append", q, k_pages, v_pages,
                  cache_lengths, page_table, softmax_scale, (new_k, new_v),
                  terms)
    paged_decode_with_append.launches += 1
    return out


_build.counter(paged_decode_with_append)


def _check_shapes(name, q, k_pages, v_pages):
    _, n_q_heads, d = q.shape
    n_kv_heads, _, _, dk = k_pages.shape
    if dk != d or v_pages.shape != k_pages.shape or n_q_heads % n_kv_heads:
        raise ValueError(
            f"{name}: shapes {tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")


def _launch(name, q, k_pages, v_pages, lengths, page_table, softmax_scale,
            new, terms):
    """Check the operands and launch K5, with the append of ``new`` =
    (new_k, new_v) first when it is given, under ``terms`` (window_left,
    num_sinks, slopes, softcap; ``paged_terms``). Returns out."""
    window_left, num_sinks, slopes, softcap = terms
    _check_shapes(name, q, k_pages, v_pages)
    batch, n_q_heads, d = q.shape
    n_kv_heads, num_pages, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    pages_max = page_table.shape[1]
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"{name}: head_dim {d} (need {HEAD_DIMS}), group "
                         f"{group} (max {MAX_GROUP})")
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32 \
            or lengths.shape != (batch,) or page_table.shape[0] != batch:
        raise ValueError(f"{name}: lengths (batch,) and page_table (batch, "
                         "pages_max) must be int32")
    _build.require_device(name, q, k_pages, v_pages, lengths, page_table)
    _build.require_cuda(name, k_pages, v_pages, lengths, page_table)
    nk = (None, None, 0, 0)
    if new is not None:
        _build.require_device(name, *new, q)
        sb, sh = new_rows(name, *new, PagedKVCache(k_pages, v_pages))
        nk = (new[0].data_ptr(), new[1].data_ptr(), sb, sh)
    if q.stride(-1) != 1 or q.stride(0) % 2 or q.stride(1) % 2 \
            or q.data_ptr() % 4:
        q = q.contiguous()  # the kernel reads q in pairs of elements
    out = torch.empty((batch, n_q_heads, d), dtype=q.dtype, device=q.device)
    # The splits cut the walk: the band and the sink tiles (all of the
    # table without a window).
    live = paged_live_span(pages_max, page_size, window_left, num_sinks)
    n_splits = paged_num_splits(batch, n_kv_heads, pages_max, page_size,
                                sm_count(q.device.index), live)
    partials = None
    if n_splits > 1:
        partials = torch.empty(n_splits * batch * n_q_heads * (d + 1),
                               dtype=torch.float32, device=q.device)
    code = _build.lib().fattn_paged_decode(
        q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(),
        v_pages.data_ptr(), lengths.data_ptr(), page_table.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        *nk, batch, n_kv_heads, group, num_pages, page_size, pages_max,
        n_splits, paged_split_keys(
            paged_live_pages(pages_max, page_size, live), page_size,
            n_splits), d,
        float(softmax_scale), -1 if window_left is None else window_left,
        num_sinks, 0.0 if softcap is None else softcap,
        None if slopes is None else slopes.data_ptr(),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(code, "fattn_paged_decode")
    return out


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_table, *,
                                 softmax_scale: float,
                                 terms=(None, 0, None, None)):
    """Plain-torch twin: walks the page table one page at a time with the
    shared liveness, mask and online-softmax update (kernels/common.py), in
    fp32. ``terms``: (window_left, num_sinks, slopes, softcap) from
    ``paged_terms``. A page no sequence has live is skipped and the keys
    the query cannot see are zeroed before the products, as the kernels
    never read them."""
    window_left, num_sinks, slopes, softcap = terms
    batch, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    qf = q.float().reshape(batch, n_kv_heads, group, d) * softmax_scale
    length = lengths.long().reshape(batch, 1, 1, 1)
    alibi_col = None if slopes is None else slopes.reshape(
        1, n_kv_heads, group, 1)
    m = torch.full((batch, n_kv_heads, group, 1), DEFAULT_MASK_VALUE,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, n_kv_heads, group, d), device=q.device)
    for j in range(page_table.shape[1]):
        live = paged_block_live(
            j, page_size, length=lengths.long(), window_left=window_left,
            first_band_pos=lengths.long() - 1 - (window_left or 0),
            num_sinks=num_sinks)
        if not bool(live.any()):
            continue
        ids = page_table[:, j].long()
        kpos = j * page_size + torch.arange(page_size, device=q.device)
        mask = paged_visibility_mask(kpos, length - 1, length=length,
                                     window_left=window_left,
                                     num_sinks=num_sinks)  # (b, 1, 1, ps)
        seen = mask[:, :, 0, :, None]  # (b, 1, ps, 1)
        k = k_pages[:, ids].float().transpose(0, 1)  # (b, h_kv, ps, d)
        v = v_pages[:, ids].float().transpose(0, 1)
        k, v = (torch.where(seen, x, 0.0) for x in (k, v))
        s = qf @ k.transpose(-1, -2)  # (b, h_kv, group, ps)
        p, alpha, m, l = paged_block_softmax(
            s, mask, m, l, softcap=softcap, alibi_col=alibi_col,
            rel=None if slopes is None else (kpos - (length - 1)).float())
        acc = acc * alpha + p @ v
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.reshape(batch, n_q_heads, d).to(q.dtype)
