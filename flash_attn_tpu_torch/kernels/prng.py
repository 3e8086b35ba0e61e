"""Counter-based dropout hash (port of ``flash_attn_tpu/kernels/prng.py``).

The keep/drop decision for attention element (b, h, i, j) is a pure
integer hash of (seed, b * h_q + h, i, j): the forward kernel, the
backward kernel and these plain functions regenerate the same mask
whatever their tiling, and only the integer seed is saved for the
backward. The CUDA kernels carry the same arithmetic in
``csrc/prng.cuh``; both must match the JAX package bit for bit.

Torch on the CPU has no ``>>`` or ``>=`` for ``torch.uint32``, so the
hash runs in int64 with every product masked to its low 32 bits (a
product of two 32-bit values may wrap in int64, but its low 32 bits are
exact).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_C0 = 0x9E3779B1  # golden-ratio odd constants for input mixing
_C1 = 0x85EBCA77
_C2 = 0xC2B2AE3D
_M0 = 0x7FEB352D  # lowbias32 multipliers
_M1 = 0x846CA68B


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _M0) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _M1) & _MASK32
    return x ^ (x >> 16)


def hash_coords(seed, bh, rows, cols) -> torch.Tensor:
    """uint32 hash (as int64) of (seed, batch * heads + head, row, col);
    the tensor arguments broadcast. Separable: the row half (one full
    mixing round) is computed before the columns join."""
    seed = int(seed) & _MASK32
    rh = _mix32(((rows * _C0) & _MASK32) ^ ((bh * _C2) & _MASK32) ^ seed)
    return _mix32(rh ^ ((cols * _C1) & _MASK32))


def dropout_threshold(p_drop: float) -> int:
    """Drop iff hash < threshold."""
    return min(int(p_drop * 4294967296.0), _MASK32)


def keep_mask(seed, bh, rows, cols, p_drop: float) -> torch.Tensor:
    """Boolean mask, True = keep; the coordinates broadcast."""
    return hash_coords(seed, bh, rows, cols) >= dropout_threshold(p_drop)


def dropout_mask_dense(seed, batch: int, heads: int, sq: int, sk: int,
                       p_drop: float, device=None) -> torch.Tensor:
    """The full (batch, heads, sq, sk) keep-mask, bit-identical to what the
    kernels generate tile by tile."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    return keep_mask(seed, ar(batch * heads).reshape(batch, heads, 1, 1),
                     ar(sq).reshape(sq, 1), ar(sk), p_drop)


def seed_value(seed) -> int:
    """A dropout seed given as an int or a 0-dim integer tensor, as the
    uint32 the kernels take."""
    if isinstance(seed, torch.Tensor):
        if seed.dim() != 0 or seed.dtype.is_floating_point:
            raise ValueError("dropout_seed must be an int or a 0-dim integer "
                             f"tensor, got {seed.dtype} {tuple(seed.shape)}")
        seed = seed.item()
    return int(seed) & _MASK32
