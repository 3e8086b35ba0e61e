"""The port's packing functions (``flash_attn_tpu_torch/ops/packing.py``)
against the JAX package's, on the same numpy inputs.

Gathers, scatters and the segment encodings are exact: every output is
held bit for bit (``np.testing.assert_array_equal``), and so are the
gradients of the gather and the scatter (a scatter-add and a gather of the
cotangent: one term per element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops import packing as jpack
from flash_attn_tpu_torch.ops import packing as tpack


def _mask(rng, b, s, lengths=None):
    if lengths is None:
        lengths = rng.integers(max(1, s // 3), s + 1, size=b)
    return np.arange(s)[None] < np.asarray(lengths)[:, None]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("total", [None, 40, 90], ids=["dynamic", "short",
                                                       "long"])
def test_unpad_input_matches_jax(total):
    """Dynamic and static ``total`` (truncating and padding: padding rows
    zero with index 0), with a row of length 0."""
    rng = np.random.default_rng(0)
    b, s = 4, 24
    mask = _mask(rng, b, s, [5, 0, 24, 13])
    x = rng.standard_normal((b, s, 3, 2)).astype(np.float32)
    want = jpack.unpad_input(jnp.asarray(x), jnp.asarray(mask), total=total)
    got = tpack.unpad_input(torch.from_numpy(x), torch.from_numpy(mask),
                            total=total)
    for g, w in zip(got[:3], want[:3]):
        _eq(g, w)
    assert got[3] == want[3]
    assert got[1].dtype == got[2].dtype == torch.int32


def test_pad_input_inverts_unpad_and_matches_jax():
    rng = np.random.default_rng(1)
    b, s = 3, 17
    mask = _mask(rng, b, s)
    x = rng.standard_normal((b, s, 5)).astype(np.float32)
    packed, idx, _, _ = tpack.unpad_input(torch.from_numpy(x),
                                          torch.from_numpy(mask))
    got = tpack.pad_input(packed, idx, b, s)
    want = jpack.pad_input(jnp.asarray(packed.numpy()),
                           jnp.asarray(idx.numpy()), b, s)
    _eq(got, want)
    _eq(got, np.where(mask[..., None], x, 0.0))


def test_index_functions_and_their_gradients_match_jax():
    """index_first_axis, index_put_first_axis, index_first_axis_residual;
    the gather's and the scatter's gradients against jax.vjp."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    idx = np.asarray([7, 0, 3, 3, 9], np.int32)  # a repeat: grads add
    g = rng.standard_normal((5, 3)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    out = tpack.index_first_axis(tx, torch.from_numpy(idx))
    want, vjp = jax.vjp(lambda a: jpack.index_first_axis(a, jnp.asarray(idx)),
                        jnp.asarray(x))
    _eq(out.detach(), want)
    out.backward(torch.from_numpy(g))
    _eq(tx.grad, vjp(jnp.asarray(g))[0])
    res = tpack.index_first_axis_residual(tx, torch.from_numpy(idx))
    jres = jpack.index_first_axis_residual(jnp.asarray(x), jnp.asarray(idx))
    for a, b in zip(res, jres):
        _eq(a.detach(), b)
    uniq = np.asarray([7, 0, 3, 9], np.int32)
    vals = torch.from_numpy(g[:4]).requires_grad_()
    put = tpack.index_put_first_axis(vals, torch.from_numpy(uniq), 10)
    jput, jvjp = jax.vjp(
        lambda a: jpack.index_put_first_axis(a, jnp.asarray(uniq), 10),
        jnp.asarray(g[:4]))
    _eq(put.detach(), jput)
    put.backward(torch.from_numpy(x))
    _eq(vals.grad, jvjp(jnp.asarray(x))[0])


@pytest.mark.parametrize("cu,total", [
    ([0, 3, 3, 7], 9),          # a zero-length sequence, padding at the end
    ([0, 0, 5], 5),             # an empty first sequence, no padding
    ([0, 4, 10, 11], 11),
    ([0, 2], 6),
], ids=str)
def test_cu_seqlens_to_segments_matches_jax(cu, total):
    cu = np.asarray(cu, np.int32)
    got = tpack.cu_seqlens_to_segments(torch.from_numpy(cu), total)
    want = jpack.cu_seqlens_to_segments(jnp.asarray(cu), total)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


def test_segment_ids_from_mask_and_back_match_jax():
    rng = np.random.default_rng(3)
    mask = _mask(rng, 3, 11, [0, 11, 4])
    got = tpack.make_segment_ids_from_mask(torch.from_numpy(mask))
    want = jpack.make_segment_ids_from_mask(jnp.asarray(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)
    _eq(tpack.segments_to_padding_mask(got[0]),
        jpack.segments_to_padding_mask(want[0]))
    _eq(tpack.segments_to_padding_mask(got[0]), mask)
