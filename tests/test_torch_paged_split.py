"""Split-KV of the paged kernels K5 and K6 against the JAX package.

The card kernels cut each sequence's keys into ranges of whole pages, give
every query row one partial per range and merge the partials in order
(csrc/paged_split.cuh). Here that algorithm runs in plain torch on the CPU
(``paged_split_plain``, ``merge_partials``) on the same numpy inputs as the
JAX package, whose Pallas kernels run in interpret mode and whose ring
attention merges partials with ``_merge_partials``. All fp32. Tolerance:
atol = rtol = 1e-5, as tests/test_torch_decode.py (fp32 sums in another
order; the observed gap is ~1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.chunk import (
    paged_chunk_attention as jax_paged_chunk_attention,
)
from flash_attn_tpu.kernels.decode import (
    paged_decode_attention as jax_paged_decode_attention,
)
from flash_attn_tpu.parallel.ring import _merge_partials
from flash_attn_tpu_torch.kernels.common import (
    SPLIT_TILE,
    merge_partials,
    paged_num_splits,
    paged_split_keys,
    paged_split_plain,
)

ATOL = RTOL = 1e-5


def _paged(rng, lengths, h_kv, d, ps, pages_max):
    """Random pages and a table giving each sequence its own pages (never
    page 0), in shuffled order."""
    num_pages = 1 + sum(-(-max(n, 0) // ps) for n in lengths)
    kp = rng.standard_normal((h_kv, num_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((h_kv, num_pages, ps, d)).astype(np.float32)
    table = np.zeros((len(lengths), pages_max), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    used = 0
    for i, n in enumerate(lengths):
        need = -(-max(n, 0) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return kp, vp, table


# (number of partials, rows whose every partial is -inf, partials that are
# -inf everywhere)
MERGE_CASES = [(2, [], []), (3, [1], []), (4, [0, 3], [2]), (5, [], [0, 1])]


@pytest.mark.parametrize("case", MERGE_CASES, ids=str)
def test_merge_partials_matches_jax(case):
    n, dead_rows, dead_parts = case
    rng = np.random.default_rng(n)
    b, s, h, d = 2, 4, 3, 8
    o = rng.standard_normal((n, b, s, h, d)).astype(np.float32)
    lse = rng.standard_normal((n, b, h, s)).astype(np.float32) * 3
    for r in dead_rows:
        lse[:, :, :, r] = -np.inf
    for i in dead_parts:
        lse[i] = -np.inf
    o_j, lse_j = jnp.asarray(o[0]), jnp.asarray(lse[0])
    for i in range(1, n):
        o_j, lse_j = _merge_partials(o_j, lse_j, jnp.asarray(o[i]),
                                     jnp.asarray(lse[i]))
    # The port takes lse in o's layout without d: (n, b, s, h).
    o_t, lse_t = merge_partials(torch.from_numpy(o), torch.from_numpy(
        lse).permute(0, 1, 3, 2))
    np.testing.assert_allclose(lse_t.permute(0, 2, 1).numpy(),
                               np.asarray(lse_j), atol=ATOL, rtol=RTOL)
    if n > 1:  # JAX merges nothing for one partial
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL,
                                   rtol=RTOL)
    for r in dead_rows:
        assert not o_t[:, r].any()  # exactly 0 where every partial is empty


# (lengths, h, h_kv, d, page_size, pages_max): ragged lengths over many
# small pages, GQA 4 at d = 128 over 128-key pages with a short and an
# empty sequence, MQA.
DECODE_CASES = [
    ([300, 17, 129, 64], 2, 2, 64, 16, 20),
    ([300, 5, 0], 8, 2, 128, 128, 3),
    ([200, 1], 4, 1, 64, 32, 7),
]


@pytest.mark.parametrize("n_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_split_decode_matches_jax(case, n_splits):
    """Decode: the query at each sequence's last position, sq = 1; 8 splits
    is more than some sequences' live pages."""
    lengths, h, h_kv, d, ps, pmax = case
    rng = np.random.default_rng(len(lengths) + d)
    kp, vp, table = _paged(rng, lengths, h_kv, d, ps, pmax)
    q = rng.standard_normal((len(lengths), h, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    out_j = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table))
    args = [torch.from_numpy(x) for x in (q[:, None], kp, vp, lens, table)]
    out_t = paged_split_plain(
        *args, chunk_lens=(args[3] > 0).to(torch.int32),
        softmax_scale=d ** -0.5, n_splits=n_splits)[:, 0]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)


# (lengths incl. the chunk, chunk_lens, sq, h, h_kv, d, page_size,
# pages_max): sq 1, 5 and 64; GQA groups 1, 4 and 8; page sizes 16 and
# 128; a length-0 slot and padding rows.
CHUNK_CASES = [
    ([40, 1, 0, 33], [1, 1, 0, 1], 1, 4, 1, 64, 16, 3),
    ([300, 64, 9, 0], [5, 5, 1, 0], 5, 8, 2, 64, 16, 20),
    ([200, 70], [64, 20], 64, 2, 2, 64, 128, 2),
    ([130, 77], [64, 64], 64, 8, 1, 64, 16, 9),
]


@pytest.mark.parametrize("n_splits", [1, 3])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_split_chunk_matches_jax(case, n_splits):
    lengths, chunk_lens, sq, h, h_kv, d, ps, pmax = case
    rng = np.random.default_rng(sq + h)
    kp, vp, table = _paged(rng, lengths, h_kv, d, ps, pmax)
    q = rng.standard_normal((len(lengths), sq, h, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    cl = np.asarray(chunk_lens, np.int32)
    out_j = jax_paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table), chunk_lens=jnp.asarray(cl))
    args = [torch.from_numpy(x) for x in (q, kp, vp, lens, table)]
    out_t = paged_split_plain(*args, chunk_lens=torch.from_numpy(cl),
                              softmax_scale=d ** -0.5, n_splits=n_splits)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    for i, c in enumerate(chunk_lens):
        assert not out_t[i, c:].any()  # padding rows are exactly 0


# (batch, h_kv, pages_max, page_size, n_sm): Llama-3-8B decode, GPT-2
# decode, one long sequence, K6's row tiles, small pages, a grid already
# past two waves, a one-page table.
SHAPES = [(8, 8, 32, 128, 132), (8, 12, 8, 128, 132), (1, 8, 128, 128, 132),
          (16, 12, 8, 128, 132), (4, 2, 20, 16, 132), (128, 8, 32, 128, 132),
          (1, 1, 1, 16, 132)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_paged_num_splits(shape):
    """At least 1, at most pages_max, no range without a page, whole pages
    and 64-key tiles, and a function of shapes only."""
    batch, h_kv, pages_max, ps, n_sm = shape
    n = paged_num_splits(*shape)
    assert isinstance(n, int) and 1 <= n <= pages_max
    assert n == paged_num_splits(*shape)
    keys = paged_split_keys(pages_max, ps, n)
    assert keys % ps == 0 and keys % SPLIT_TILE == 0
    assert (n - 1) * keys < pages_max * ps <= n * keys
    if batch * h_kv >= 2 * n_sm:
        assert n == 1  # the grid already fills two waves
