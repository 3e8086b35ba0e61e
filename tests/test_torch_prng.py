"""The port's dropout hash against the JAX package's, bit for bit.

``flash_attn_tpu_torch.kernels.prng.dropout_mask_dense`` must equal
``flash_attn_tpu.kernels.prng.dropout_mask_dense`` exactly (tolerance: none)
for every seed, shape and drop probability: the forward and backward
kernels regenerate the mask from the same hash, and the port's dropout is
held to the JAX package's through it. The drop fraction is held within
[0.99, 1.01] x p, as tests/test_dropout.py holds the JAX mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels import prng as jax_prng
from flash_attn_tpu_torch.kernels import prng

SEEDS = [0, 1, 1234, 2 ** 32 - 1]
P_DROPS = [0.1, 0.17, 0.9]


@pytest.mark.parametrize("p_drop", P_DROPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_dense_mask_bit_equal_to_jax(seed, p_drop):
    b, h, sq, sk = 2, 3, 300, 257  # b*h > 1, ragged
    want = np.asarray(jax_prng.dropout_mask_dense(jnp.uint32(seed), b, h, sq,
                                                  sk, p_drop))
    got = prng.dropout_mask_dense(seed, b, h, sq, sk, p_drop).numpy()
    assert got.shape == (b, h, sq, sk) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    frac = 1.0 - got.mean()
    assert 0.99 * p_drop <= frac <= 1.01 * p_drop, frac


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_bit_equal_to_jax(seed):
    rows = np.arange(0, 5000, 7, dtype=np.uint32)[:, None]
    cols = np.arange(0, 3000, 11, dtype=np.uint32)[None, :]
    bh = np.uint32(37)
    want = np.asarray(jax_prng.hash_coords(jnp.uint32(seed), jnp.uint32(bh),
                                           jnp.asarray(rows),
                                           jnp.asarray(cols)))
    got = prng.hash_coords(seed, torch.tensor(int(bh)),
                           torch.from_numpy(rows.astype(np.int64)),
                           torch.from_numpy(cols.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("p_drop", [0.0, 1e-12, 0.5, 1.0 - 1e-12])
def test_threshold_matches_jax(p_drop):
    assert prng.dropout_threshold(p_drop) == int(
        jax_prng.dropout_threshold(p_drop))
