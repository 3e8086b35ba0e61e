"""flash_attn_tpu_torch paged-cache writes and page allocator against the
JAX package.

Writes must be bitwise equal to JAX's outside the reserved scratch page 0:
inactive slots and padded page lists all write page 0, which on the card
is a race (harmless: page 0 is never read unmasked), so page 0 is
excluded. The allocator is driven by one random op sequence on both sides.
The kernels themselves are tested on the card in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.serving import cache as jax_cache
from flash_attn_tpu_torch.serving import cache as torch_cache

H, D, PS, NUM_PAGES = 2, 64, 16, 13


def _caches(seed):
    """The same non-zero starting pages on both sides, so untouched pages
    are checked too."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((H, NUM_PAGES, PS, D)).astype(np.float32)
    v = rng.standard_normal((H, NUM_PAGES, PS, D)).astype(np.float32)
    jc = jax_cache.PagedKVCache(jnp.asarray(k), jnp.asarray(v), None, None)
    tc = torch_cache.PagedKVCache(torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc


def _assert_equal_outside_page0(jc, tc):
    for j, t in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        np.testing.assert_array_equal(t.numpy()[:, 1:],
                                      np.asarray(j)[:, 1:])


@pytest.mark.parametrize("prompt_len,page_ids", [
    (16, [3]),             # exactly one full page
    (37, [5, 2, 7]),       # tail page zero-filled
    (20, [4, 0, 0]),       # list padded with scratch page 0
])
def test_write_prompt_matches_jax(prompt_len, page_ids):
    jc, tc = _caches(0)
    rng = np.random.default_rng(1)
    k = rng.standard_normal((prompt_len, H, D)).astype(np.float32)
    v = rng.standard_normal((prompt_len, H, D)).astype(np.float32)
    ids = np.asarray(page_ids, np.int32)
    jc = jax_cache.write_prompt(jc, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(ids))
    out = torch_cache.write_prompt(tc, torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(ids))
    assert out is tc  # in place
    _assert_equal_outside_page0(jc, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt_len,table", [
    # zero tail; a row padded with page 0; a row that is all padding
    (37, [[5, 2, 7], [8, 0, 0], [0, 0, 0]]),
    # whole pages, the last row's list padded with page 0
    (48, [[1, 3, 4], [6, 9, 10], [11, 12, 0]]),
])
def test_batched_write_matches_jax_row_loop(dtype, prompt_len, table):
    """The batched page write (one launch per layer on the card) against
    the JAX package's loop of write_prompt over the rows, as chunked and
    single-shot prefill called it: bitwise outside page 0."""
    jc, tc = _caches(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc = jax_cache.PagedKVCache(jc.k_pages.astype(jdt),
                                jc.v_pages.astype(jdt), None, None)
    tc = torch_cache.PagedKVCache(tc.k_pages.to(tdt), tc.v_pages.to(tdt))
    rng = np.random.default_rng(6)
    b = len(table)
    k = rng.standard_normal((b, prompt_len, H, D)).astype(np.float32)
    v = rng.standard_normal((b, prompt_len, H, D)).astype(np.float32)
    ids = np.asarray(table, np.int32)
    for r in range(b):
        jc = jax_cache.write_prompt(jc, jnp.asarray(k[r], jdt),
                                    jnp.asarray(v[r], jdt),
                                    jnp.asarray(ids[r]))
    out = torch_cache._write_prompts(tc, torch.from_numpy(k).to(tdt),
                                     torch.from_numpy(v).to(tdt),
                                     torch.from_numpy(ids))
    assert out is tc  # in place
    for j, t in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        np.testing.assert_array_equal(
            t.float().numpy()[:, 1:],
            np.asarray(j.astype(jnp.float32))[:, 1:])


@pytest.mark.parametrize("lengths", [
    [0, 15, 16, 40],   # first slot, last slot of a page, next page, later
    [5, -1, 33, -1],   # inactive slots go to page 0
])
def test_append_token_matches_jax(lengths):
    jc, tc = _caches(2)
    rng = np.random.default_rng(3)
    b = len(lengths)
    # Pages are owned by one sequence each, as the allocator hands them out.
    table = np.asarray([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]],
                       np.int32)[:b]
    lens = np.asarray(lengths, np.int32)
    nk = rng.standard_normal((b, H, D)).astype(np.float32)
    nv = rng.standard_normal((b, H, D)).astype(np.float32)
    jc = jax_cache.append_token(jc, jnp.asarray(nk), jnp.asarray(nv),
                                jnp.asarray(table), jnp.asarray(lens))
    out = torch_cache.append_token(tc, torch.from_numpy(nk),
                                   torch.from_numpy(nv),
                                   torch.from_numpy(table),
                                   torch.from_numpy(lens))
    assert out is tc
    _assert_equal_outside_page0(jc, tc)


def test_page_allocator_op_sequence_matches_jax():
    rng = np.random.default_rng(4)
    ja = jax_cache.PageAllocator(24, 16, 6)
    ta = torch_cache.PageAllocator(24, 16, 6)
    live: dict[int, int] = {}
    next_id = 0
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:  # admit
            n = int(rng.integers(1, 80))
            assert ja.can_admit(n) == ta.can_admit(n)
            if ja.can_admit(n):
                assert ja.alloc(next_id, n) == ta.alloc(next_id, n)
                live[next_id] = n
                next_id += 1
        elif op == 1 and live:  # grow
            sid = int(rng.choice(list(live)))
            n = live[sid] + int(rng.integers(1, 20))
            results = []
            for a in (ja, ta):
                try:
                    results.append(a.extend(sid, n))
                except RuntimeError as e:
                    results.append(str(e))
            assert results[0] == results[1]
            if not isinstance(results[0], str):
                live[sid] = n
        elif op == 2 and live:  # release
            sid = int(rng.choice(list(live)))
            ja.release(sid)
            ta.release(sid)
            del live[sid]
        for sid in live:
            assert ja.table_row(sid) == ta.table_row(sid)
        assert ja.free_pages == ta.free_pages


def test_quantized_cache_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP port item M5"):
        torch_cache.init_cache(H, 4, PS, D, quantization="int8")


@pytest.mark.parametrize("span", [False, True], ids=["token", "span"])
def test_appends_take_projection_views(span):
    """append_token and append_span given k and v as views of a fused
    (b, [sq,] 3, h, d) projection write what their contiguous calls write;
    new_rows reads those views' strides and refuses rows it cannot move as
    16-byte vectors."""
    rng = np.random.default_rng(9)
    b, sq = 4, 5
    lens = torch.tensor([0, 15, -1, 30], dtype=torch.int32)
    table = torch.from_numpy(np.asarray(
        [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]], np.int32))
    shape = (b, sq, 3, H, D) if span else (b, 3, H, D)
    fused = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    _, k, v = fused.unbind(-3)
    assert not k.is_contiguous()
    caches = []
    for kk, vv in ((k, v), (k.contiguous(), v.contiguous())):
        _, tc = _caches(10)
        if span:
            torch_cache.append_span(tc, kk, vv, table, lens,
                                    torch.tensor([5, 3, 5, 0],
                                                 dtype=torch.int32))
        else:
            torch_cache.append_token(tc, kk, vv, table, lens)
        caches.append(tc)
    assert torch.equal(caches[0].k_pages, caches[1].k_pages)
    assert torch.equal(caches[0].v_pages, caches[1].v_pages)
    assert torch_cache.new_rows("test", k, v, caches[0]) == list(
        k.stride()[:-1])
    with pytest.raises(ValueError, match="16-byte"):
        torch_cache.new_rows("test", k, v.contiguous(), caches[0])
    with pytest.raises(ValueError, match="16-byte"):
        torch_cache.new_rows("test", k[..., 1:-1], v[..., 1:-1], caches[0])
