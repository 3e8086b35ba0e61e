"""Paged KV cache: device tensors updated in place + host page allocator
(port of ``flash_attn_tpu/serving/cache.py``).

``PagedKVCache`` holds one layer's pages. The three writes (one token,
a span of tokens, whole pages) are CUDA kernels
(``csrc/cache_write.cu``) that update the pages IN PLACE, where the JAX
package's were functional with input/output aliasing; each still returns
the cache so call sites read the same. They read their sources through
strides (``new_rows``), so callers pass views of their projections. The
serving path appends inside the attention launch that reads the new rows
(``kernels/decode.py`` ``paged_decode_with_append``,
``kernels/chunk.py`` ``paged_chunk_attention(new_k=...)``); the
standalone appends here serve every other caller. ``PageAllocator`` is
the host-side bookkeeping the serving engine uses to hand pages to
sequences.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attn_tpu_torch.kernels import _build


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer paged cache in the model dtype (quantized payloads with
    per-token scales are ROADMAP port item M5)."""

    k_pages: torch.Tensor  # (n_kv_heads, num_pages, page_size, d)
    v_pages: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


def init_cache(n_kv_heads: int, num_pages: int, page_size: int,
               head_dim: int, *, dtype=torch.bfloat16, device="cuda",
               quantization: str | None = None) -> PagedKVCache:
    if quantization is not None:
        raise NotImplementedError(
            f"quantization={quantization!r}: quantized KV is ROADMAP port "
            "item M5")
    shape = (n_kv_heads, num_pages, page_size, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
    )


def _check_dtype(name, cache, *tensors):
    for t in tensors:
        if t.dtype != cache.k_pages.dtype:
            raise ValueError(f"{name}: payload {t.dtype} into a "
                             f"{cache.k_pages.dtype} cache")


def new_rows(name, k, v, cache: PagedKVCache) -> list[int]:
    """The element strides of every dimension but the last of ``k`` and
    ``v`` (shared), which the cache-write kernels read through: raise unless
    the last dimension is contiguous and every row, the data and the cache
    sit on 16-byte boundaries (the kernels move 16-byte vectors). A
    dimension of size 1 has no stride that matters: 0."""
    size = k.element_size()
    strides = [0 if n == 1 else st for n, st in zip(k.shape[:-1],
                                                    k.stride()[:-1])]
    same = all(n == 1 or a == b for n, a, b in zip(
        k.shape[:-1], k.stride()[:-1], v.stride()[:-1]))
    if not same or k.stride(-1) != 1 or v.stride(-1) != 1 or any(
            x * size % 16 for x in (k.shape[-1], *strides)) or any(
            x.data_ptr() % 16 for x in (k, v, cache.k_pages, cache.v_pages)):
        raise ValueError(f"{name}: k and v need the same strides, a "
                         "contiguous head dimension and 16-byte aligned "
                         "rows (the kernel moves 16-byte vectors)")
    return strides


def append_token(cache: PagedKVCache, new_k, new_v, page_table, lengths
                 ) -> PagedKVCache:
    """Write one token per sequence at its next slot, IN PLACE.

    new_k/new_v (batch, n_kv_heads, d); page_table (batch, pages_max) int32;
    lengths (batch,) int32, the length BEFORE the append. A negative length
    marks an inactive slot: its write goes to the reserved scratch page 0,
    so a stale page-table row never corrupts a page given to another
    sequence. new_k/new_v may be views (``new_rows``). Replaces
    ``cache.py:_append_kernel``."""
    _check_dtype("append_token", cache, new_k, new_v)
    batch, h, d = new_k.shape
    n_kv, num_pages, ps, dk = cache.k_pages.shape
    if new_v.shape != new_k.shape or (h, d) != (n_kv, dk) \
            or lengths.shape != (batch,) or page_table.shape[0] != batch:
        raise ValueError(f"append_token: new_k {tuple(new_k.shape)}, pages "
                         f"{tuple(cache.k_pages.shape)}")
    if new_k.device.type == "cpu":
        return append_token_plain(cache, new_k, new_v, page_table, lengths)
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("append_token: page_table and lengths must be int32")
    _build.require_cuda("append_token", cache.k_pages, cache.v_pages,
                        page_table, lengths)
    _build.require_device("append_token", new_k, new_v, cache.k_pages)
    code = _build.lib().fattn_append_token(
        new_k.data_ptr(), new_v.data_ptr(), cache.k_pages.data_ptr(),
        cache.v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        batch, h, num_pages, ps, page_table.shape[1], d,
        *new_rows("append_token", new_k, new_v, cache),
        new_k.element_size(), _build.stream_ptr(new_k.device),
    )
    append_token.launches += 1
    _build.check(code, "fattn_append_token")
    return cache


_build.counter(append_token)


def append_token_plain(cache: PagedKVCache, new_k, new_v, page_table,
                       lengths) -> PagedKVCache:
    """Plain-torch twin of ``append_token`` (in place). Inactive sequences
    (length < 0) and lengths past the table write slot 0 of page 0."""
    ps, pages_max = cache.page_size, page_table.shape[1]
    page_pos = lengths.long().clamp(min=0) // ps
    ok = (lengths >= 0) & (page_pos < pages_max)
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    page_ids = torch.where(
        ok, page_table[rows, page_pos.clamp(max=pages_max - 1)].long(), 0)
    slots = torch.where(ok, lengths.long() % ps, 0)
    cache.k_pages[:, page_ids, slots] = new_k.transpose(0, 1)
    cache.v_pages[:, page_ids, slots] = new_v.transpose(0, 1)
    return cache


def append_span(cache: PagedKVCache, new_k, new_v, page_table, lengths,
                new_lens=None) -> PagedKVCache:
    """Write up to ``sq`` tokens per sequence IN PLACE in one launch.

    new_k/new_v (batch, sq, n_kv_heads, d); page_table (batch, pages_max)
    int32; lengths (batch,) int32, the length BEFORE the append; new_lens
    (batch,) int32 valid rows (default sq). Token t of sequence b lands at
    slot ``lengths[b] + t`` for ``t < new_lens[b]``. Inactive sequences
    (length < 0), padding rows and slots past the page table write nothing.
    new_k/new_v may be views (``new_rows``). Replaces
    ``cache.py:_append_span_kernel``."""
    _check_dtype("append_span", cache, new_k, new_v)
    batch, sq, h, d = new_k.shape
    n_kv, num_pages, ps, dk = cache.k_pages.shape
    if new_lens is None:
        new_lens = torch.full((batch,), sq, dtype=torch.int32,
                              device=new_k.device)
    if new_v.shape != new_k.shape or (h, d) != (n_kv, dk) \
            or lengths.shape != (batch,) or new_lens.shape != (batch,) \
            or page_table.shape[0] != batch:
        raise ValueError(f"append_span: new_k {tuple(new_k.shape)}, pages "
                         f"{tuple(cache.k_pages.shape)}")
    if new_k.device.type == "cpu":
        return append_span_plain(cache, new_k, new_v, page_table, lengths,
                                 new_lens)
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or new_lens.dtype != torch.int32:
        raise ValueError("append_span: page_table, lengths and new_lens "
                         "must be int32")
    _build.require_cuda("append_span", cache.k_pages, cache.v_pages,
                        page_table, lengths, new_lens)
    _build.require_device("append_span", new_k, new_v, cache.k_pages)
    code = _build.lib().fattn_append_span(
        new_k.data_ptr(), new_v.data_ptr(), cache.k_pages.data_ptr(),
        cache.v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        new_lens.data_ptr(), batch, sq, h, num_pages, ps,
        page_table.shape[1], d,
        *new_rows("append_span", new_k, new_v, cache),
        new_k.element_size(), _build.stream_ptr(new_k.device),
    )
    append_span.launches += 1
    _build.check(code, "fattn_append_span")
    return cache


_build.counter(append_span)


def append_span_plain(cache: PagedKVCache, new_k, new_v, page_table,
                      lengths, new_lens) -> PagedKVCache:
    """Plain-torch twin of ``append_span`` (in place)."""
    ps, pages_max = cache.page_size, page_table.shape[1]
    batch, sq = new_k.shape[:2]
    t = torch.arange(sq, device=new_k.device)
    pos = lengths.long()[:, None] + t  # (b, sq)
    write = (lengths[:, None] >= 0) & (t < new_lens[:, None]) \
        & (pos // ps < pages_max)
    b_idx, t_idx = write.nonzero(as_tuple=True)
    p = pos[b_idx, t_idx]
    pages = page_table[b_idx, p // ps].long()
    cache.k_pages[:, pages, p % ps] = new_k[b_idx, t_idx].transpose(0, 1)
    cache.v_pages[:, pages, p % ps] = new_v[b_idx, t_idx].transpose(0, 1)
    return cache


def write_prompt(cache: PagedKVCache, k, v, page_ids) -> PagedKVCache:
    """Write a whole prompt's K/V (prompt_len, n_kv_heads, d) into its
    pages ``page_ids`` (ceil(prompt_len / page_size),) IN PLACE; the tail of
    the last page is zero-filled. Replaces ``cache.py:_write_pages_kernel``.

    Several entries of ``page_ids`` may name the scratch page 0 (the engine
    pads page lists with it); on the card those writes race, which is
    harmless because page 0 is never read unmasked. One row of
    ``_write_prompts``, which launches the kernel."""
    return _write_prompts(cache, k[None], v[None], page_ids[None])


def write_prompt_plain(cache: PagedKVCache, k, v, page_ids) -> PagedKVCache:
    """Plain-torch twin of ``write_prompt`` (in place)."""
    return _write_prompts_plain(cache, k[None], v[None], page_ids[None])


def _write_prompts(cache: PagedKVCache, k, v, page_table) -> PagedKVCache:
    """``write_prompt`` for every row at once, IN PLACE and in one launch:
    row r of k/v (b, prompt_len, n_kv_heads, d) goes to the pages
    ``page_table[r]`` (b, n_pages) int32, tail zero-filled. The cache ends
    as the JAX package's loop of ``write_prompt`` over the rows leaves it,
    outside the scratch page 0. k and v may be strided views
    (``new_rows``)."""
    _check_dtype("write_prompt", cache, k, v)
    b, prompt_len, h, d = k.shape
    n_kv, num_pages, ps, dk = cache.k_pages.shape
    n_pages = page_table.shape[1]
    if v.shape != k.shape or (h, d) != (n_kv, dk) \
            or page_table.shape[0] != b or prompt_len > n_pages * ps:
        raise ValueError(f"write_prompt: k {tuple(k.shape)} into "
                         f"{tuple(page_table.shape)} pages of "
                         f"{tuple(cache.k_pages.shape)}")
    if k.device.type == "cpu":
        return _write_prompts_plain(cache, k, v, page_table)
    if page_table.dtype != torch.int32:
        raise ValueError("write_prompt: page ids must be int32")
    _build.require_cuda("write_prompt", cache.k_pages, cache.v_pages,
                        page_table)
    _build.require_device("write_prompt", k, v, cache.k_pages)
    code = _build.lib().fattn_write_pages(
        k.data_ptr(), v.data_ptr(), cache.k_pages.data_ptr(),
        cache.v_pages.data_ptr(), page_table.data_ptr(), b, prompt_len,
        n_pages, h, num_pages, ps, d, *new_rows("write_prompt", k, v, cache),
        k.element_size(), _build.stream_ptr(k.device),
    )
    _write_prompts.launches += 1
    _build.check(code, "fattn_write_pages")
    return cache


_build.counter(_write_prompts)


def _write_prompts_plain(cache: PagedKVCache, k, v, page_table
                         ) -> PagedKVCache:
    """Plain-torch twin of ``_write_prompts`` (in place)."""
    b, prompt_len, h, d = k.shape
    n_pages, ps = page_table.shape[1], cache.page_size
    ids = page_table.reshape(-1).long()
    for x, pages in ((k, cache.k_pages), (v, cache.v_pages)):
        xp = x.new_zeros((b, n_pages * ps, h, d))
        xp[:, :prompt_len] = x
        pages[:, ids] = xp.reshape(b * n_pages, ps, h, d).permute(2, 0, 1, 3)
    return cache


class PageAllocator:
    """Host-side physical-page bookkeeping for continuous batching (the
    JAX package's, unchanged)."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int,
                 reserved: int = 1):
        """``reserved`` low page ids are never handed out. Defaults to 1
        because ``append_token`` redirects inactive-slot writes to page 0
        as scratch: handing page 0 to a sequence would let those writes
        corrupt it."""
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.capacity = num_pages - reserved  # total allocatable pages
        self._free = list(range(num_pages - 1, reserved - 1, -1))
        self._owned: dict[int, list[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_admit(self, prompt_len: int) -> bool:
        need = (prompt_len + self.page_size - 1) // self.page_size
        return len(self._free) >= need

    def alloc(self, seq_id: int, prompt_len: int) -> list[int]:
        need = (prompt_len + self.page_size - 1) // self.page_size
        if need > self.pages_per_seq:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds pages_per_seq"
            )
        if len(self._free) < need:
            raise RuntimeError("out of KV-cache pages")
        pages = [self._free.pop() for _ in range(need)]
        self._owned[seq_id] = pages
        return pages

    def extend(self, seq_id: int, new_length: int) -> int | None:
        """Ensure capacity for new_length tokens; returns a newly assigned
        page id if one was needed."""
        pages = self._owned[seq_id]
        need = (new_length + self.page_size - 1) // self.page_size
        if need <= len(pages):
            return None
        if need > self.pages_per_seq:
            raise RuntimeError("sequence exceeded pages_per_seq")
        if not self._free:
            raise RuntimeError("out of KV-cache pages")
        page = self._free.pop()
        pages.append(page)
        return page

    def release(self, seq_id: int) -> None:
        self._free.extend(
            p for p in reversed(self._owned.pop(seq_id)) if p != 0
        )

    def release_range(self, seq_id: int, start_page: int,
                      end_page: int) -> int:
        """Free logical pages [start_page, end_page) of a LIVE sequence
        (streaming sliding-window serving: pages that fell out of the
        attention band for good). A freed slot keeps a page-0 placeholder,
        so logical indexing (``extend`` / ``table_row``) is unchanged; the
        paged kernels never fetch a key below the band. Returns the number
        of pages freed (idempotent: freed slots are skipped; page 0 is
        reserved, so the placeholder is unambiguous)."""
        pages = self._owned[seq_id]
        freed = 0
        for p in range(max(start_page, 0), min(end_page, len(pages))):
            if pages[p] != 0:
                self._free.append(pages[p])
                pages[p] = 0
                freed += 1
        return freed

    def table_row(self, seq_id: int) -> list[int]:
        pages = self._owned[seq_id]
        return pages + [0] * (self.pages_per_seq - len(pages))
