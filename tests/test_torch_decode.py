"""flash_attn_tpu_torch paged decode attention against the JAX package.

The same numpy inputs (queries, pages, random page tables, lengths) go to
both. On the CPU the port runs the kernel's plain-torch twin and JAX runs
its Pallas kernel in interpret mode. fp32 parity tolerance: atol = rtol =
1e-5 (different summation order; the observed gap is ~1e-6). Decode with
the append (``paged_decode_with_append``) goes against JAX's
``append_token`` followed by its ``paged_decode_attention``: the output at
that tolerance, the cache bitwise outside the scratch page 0. The kernels
themselves are tested on the card in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.decode import (
    paged_decode_attention as jax_paged_decode_attention,
)
from flash_attn_tpu.serving import cache as jax_cache
from flash_attn_tpu_torch.kernels.decode import (
    paged_decode_attention,
    paged_decode_with_append,
)
from flash_attn_tpu_torch.reference import paged_chunk_ref

ATOL = RTOL = 1e-5


def _inputs(seed, lengths, h, h_kv, d, page_size, num_pages, pages_max):
    """Random q/pages and a page table giving each sequence distinct
    physical pages (never the reserved page 0)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((h_kv, num_pages, page_size, d)).astype(np.float32)
    vp = rng.standard_normal((h_kv, num_pages, page_size, d)).astype(np.float32)
    table = np.zeros((b, pages_max), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    used = 0
    for i, n in enumerate(lengths):
        need = -(-max(n, 0) // page_size)
        table[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, np.asarray(lengths, np.int32), table


# (lengths, h, h_kv, d, page_size, pages_max)
CASES = [
    ([1, 16, 17, 40], 2, 2, 64, 16, 3),           # one token / full page / next
    ([33, 48, 5], 4, 2, 64, 16, 4),               # multi-page, GQA group 2
    ([100, 7], 8, 2, 128, 32, 4),                 # head_dim 128, GQA group 4
    ([64, 0, 12], 2, 1, 64, 16, 4),               # MQA, an empty sequence
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_matches_jax_fp32(case):
    lengths, h, h_kv, d, ps, pmax = case
    q, kp, vp, lens, table = _inputs(0, lengths, h, h_kv, d, ps, 16, pmax)
    out_j = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table),
    )
    out_t = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(table),
    )
    assert out_t.shape == (len(lengths), h, d)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)


def _dense_ref(q, kp, vp, lens, table):
    """The dense chunk oracle at sq = 1: each sequence's keys gathered, the
    query at the last position, so every key below the length is
    visible."""
    one = (lens > 0).to(torch.int32)
    return paged_chunk_ref(q[:, None], kp, vp, lens, table, one)[:, 0]


def test_plain_twin_matches_dense_oracle():
    q, kp, vp, lens, table = (torch.from_numpy(x) for x in _inputs(
        1, [1, 16, 31, 47], 4, 2, 64, 16, 16, 3))
    out = paged_decode_attention(q, kp, vp, lens, table)
    torch.testing.assert_close(out, _dense_ref(q, kp, vp, lens, table),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name,value", [
    ("k_scales", np.ones(1)), ("window_left", 8), ("alibi_slopes", [1.0]),
    ("softcap", 30.0),
])
def test_unported_arguments_raise(name, value):
    """k_scales (M5) still raises; the M4 terms run and match JAX."""
    q, kp, vp, lens, table = _inputs(2, [40, 3], 1, 1, 64, 16, 8, 3)
    if name == "k_scales":
        with pytest.raises(NotImplementedError, match="ROADMAP port item M5"):
            paged_decode_attention(*(torch.from_numpy(x) for x in (
                q, kp, vp, lens, table)), **{name: value})
        return
    out_j = jax_paged_decode_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, lens, table)), **{name: value})
    out_t = paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, lens, table)),
        **{name: value})
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)


# (cache lengths before the append, h, h_kv, d, page_size, pages_max):
# length 0, a page's last slot, the next page, an inactive slot (its table
# row stale but its own), a position past the table.
APPEND_CASES = [
    ([0, 15, 16, -1], 2, 2, 64, 16, 3),
    ([31, 0, -1, 47, 48], 8, 2, 128, 16, 3),  # GQA group 4, past the table
    ([63, 64, 5], 4, 4, 64, 32, 4),
]


def _append_inputs(seed, lengths, h, h_kv, d, ps, pmax):
    """Pages, q, the new rows and a table in which every sequence owns
    pmax pages of its own (never page 0)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, kp, vp, _, _ = _inputs(seed, [0], h, h_kv, d, ps, 1 + b * pmax, 1)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    table = (1 + rng.permutation(b * pmax)).reshape(b, pmax).astype(np.int32)
    nk = rng.standard_normal((b, h_kv, d)).astype(np.float32)
    nv = rng.standard_normal((b, h_kv, d)).astype(np.float32)
    return q, kp, vp, np.asarray(lengths, np.int32), table, nk, nv


@pytest.mark.parametrize("case", APPEND_CASES, ids=str)
def test_decode_with_append_matches_jax_pair(case):
    """paged_decode_with_append against JAX's append_token followed by
    paged_decode_attention over max(length, 0) + 1 keys."""
    lengths, h, h_kv, d, ps, pmax = case
    q, kp, vp, lens, table, nk, nv = _append_inputs(3, lengths, h, h_kv, d,
                                                    ps, pmax)
    jc = jax_cache.append_token(
        jax_cache.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp), None, None),
        jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table),
        jnp.asarray(lens))
    out_j = jax_paged_decode_attention(
        jnp.asarray(q), jc.k_pages, jc.v_pages,
        jnp.asarray(np.maximum(lens, 0) + 1), jnp.asarray(table))
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out_t = paged_decode_with_append(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
        kp_t, vp_t, torch.from_numpy(lens), torch.from_numpy(table))
    assert out_t.shape == q.shape
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    for j, t in ((jc.k_pages, kp_t), (jc.v_pages, vp_t)):
        np.testing.assert_array_equal(t.numpy()[:, 1:], np.asarray(j)[:, 1:])


def test_decode_with_append_takes_projection_views():
    """k and v as views of GPT-2's fused (b, 3, h, d) projection, q too:
    what the contiguous call gives, output and cache."""
    lengths, h, d, ps, pmax = [0, 15, 16, -1], 4, 64, 16, 3
    q, kp, vp, lens, table, _, _ = _append_inputs(4, lengths, h, h, d, ps,
                                                  pmax)
    fused = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (len(lengths), 3, h, d)).astype(np.float32))
    views = fused.unbind(1)
    assert not views[1].is_contiguous()
    outs = []
    for q_, k_, v_ in (views, [x.contiguous() for x in views]):
        pages = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
        outs.append((paged_decode_with_append(
            q_, k_, v_, *pages, torch.from_numpy(lens),
            torch.from_numpy(table)), *pages))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
