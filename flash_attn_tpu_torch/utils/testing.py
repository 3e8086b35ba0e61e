"""Test helpers: the repo's dual-reference error bound, in torch
(port of ``flash_attn_tpu/utils/testing.py``)."""

from __future__ import annotations

import numpy as np
import torch


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_two_x_bound(out, ref_f32, ref_native, *, mult=2.0, atol=1e-5,
                       label=""):
    """assert max|out - ref_f32| <= mult * max|ref_native - ref_f32| + atol.

    ``atol`` floors the bound for fp32 inputs where the baseline error is 0.
    Returns ``(err, baseline)``."""
    err = max_err(out, ref_f32)
    base = max_err(ref_native, ref_f32)
    assert err <= mult * base + atol, (
        f"{label}: kernel err {err:.3e} > {mult} * baseline {base:.3e} + {atol}"
    )
    return err, base


def random_qkv(rng: np.random.Generator, b, sq, sk, h, d, dtype,
               h_kv=None):
    """Standard-normal q (b, sq, h, d) and k, v (b, sk, h_kv, d) from a
    numpy generator, so JAX and torch tests can share the same inputs."""
    h_kv = h if h_kv is None else h_kv

    def make(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    return make((b, sq, h, d)), make((b, sk, h_kv, d)), make((b, sk, h_kv, d))
