"""The port's rotary embeddings (``flash_attn_tpu_torch/ops/rotary.py``)
against the JAX package's ``flash_attn_tpu/ops/rotary.py``, on the same
numpy inputs, in fp32: 1-D and 2-D, sequence dimension -2 and -3,
explicit positions. Tolerance atol = rtol = 1e-5 (sin/cos of the same fp32
angles, computed by two libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops import rotary as jrot
from flash_attn_tpu_torch.ops import rotary as trot

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_tables_and_rotate_half_match_jax():
    for g, w in zip(trot.rotary_cos_sin(37, 16),
                    jrot.rotary_cos_sin(37, 16)):
        _close(g, w)
    x = _x(0, (3, 5, 8))
    _close(trot.rotate_half(torch.from_numpy(x)),
           jrot.rotate_half(jnp.asarray(x)))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("seq_dimension", [-2, -3])
def test_rotary_1d_matches_jax(seq_dimension, d):
    shape = (2, 3, 40, d) if seq_dimension == -2 else (2, 40, 3, d)
    q, k = _x(1, shape), _x(2, shape)
    got = trot.RotaryEmbedding(d)(torch.from_numpy(q), torch.from_numpy(k),
                                  seq_dimension=seq_dimension)
    want = jrot.RotaryEmbedding(d)(jnp.asarray(q), jnp.asarray(k),
                                   seq_dimension=seq_dimension)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seq_dimension", [-2, -3])
def test_rotary_2d_matches_jax(seq_dimension):
    d, side = 32, 6
    shape = (2, 2, side * side, d) if seq_dimension == -2 \
        else (2, side * side, 2, d)
    q, k = _x(3, shape), _x(4, shape)
    got = trot.RotaryEmbedding2D(d)(torch.from_numpy(q), torch.from_numpy(k),
                                    seq_dimension=seq_dimension)
    want = jrot.RotaryEmbedding2D(d)(jnp.asarray(q), jnp.asarray(k),
                                     seq_dimension=seq_dimension)
    for g, w in zip(got, want):
        _close(g, w)


def test_rotary_2d_needs_a_square_grid():
    x = torch.zeros(1, 1, 10, 16)
    with pytest.raises(ValueError, match="square grid"):
        trot.RotaryEmbedding2D(16)(x, x)


@pytest.mark.parametrize("dim", [None, 32])
def test_apply_rotary_at_positions_matches_jax(dim):
    """(b, s, h, d) with (b, s, 1) positions (the kvcache form) and
    (b, h, s, d) with (b, 1, s), varlen positions restarting mid-row;
    ``dim`` given or taken from x."""
    x = _x(5, (2, 9, 3, 32))
    pos = np.asarray([[0, 1, 2, 3, 0, 1, 2, 0, 1],
                      [7, 8, 9, 10, 11, 12, 13, 14, 15]], np.int32)
    got = trot.apply_rotary_at_positions(
        torch.from_numpy(x), torch.from_numpy(pos)[:, :, None], dim)
    want = jrot.apply_rotary_at_positions(jnp.asarray(x),
                                          jnp.asarray(pos)[:, :, None], dim)
    _close(got, want)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    got = trot.apply_rotary_at_positions(
        torch.from_numpy(xt), torch.from_numpy(pos)[:, None], dim)
    want = jrot.apply_rotary_at_positions(jnp.asarray(xt),
                                          jnp.asarray(pos)[:, None], dim)
    _close(got, want)


def test_positions_arange_equals_the_table_form():
    x = torch.from_numpy(_x(6, (2, 3, 20, 16)))
    cos, sin = trot.rotary_cos_sin(20, 16)
    torch.testing.assert_close(
        trot.apply_rotary_at_positions(x, torch.arange(20)),
        trot.apply_rotary_pos_emb(x, cos, sin), atol=1e-6, rtol=1e-6)
