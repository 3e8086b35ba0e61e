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


def packed_views(qkv, h, h_kv, d):
    """q, k, v as the GPT-2 block makes them from its fused projection
    (b, s, (h + 2 h_kv) d): (b, s, 3, h, d) unbound for MHA, column slices
    for GQA (models/modules.py FlashMHA.forward)."""
    b, s, _ = qkv.shape
    if h == h_kv:
        return qkv.reshape(b, s, 3, h, d).unbind(dim=2)
    return (qkv[..., : h * d].reshape(b, s, h, d),
            qkv[..., h * d: (h + h_kv) * d].reshape(b, s, h_kv, d),
            qkv[..., (h + h_kv) * d:].reshape(b, s, h_kv, d))


def cu_seqlens(lengths) -> np.ndarray:
    """(n + 1,) int32 offsets of packed sequences of these lengths."""
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


def packed_segments(lengths, total: int):
    """Segment ids and local positions (total,) int32 of sequences of
    ``lengths`` packed from token 0 on; tokens past them get id -1 and
    position 0 (``ops/packing.py`` ``cu_seqlens_to_segments``)."""
    ids = np.full(total, -1, np.int32)
    pos = np.zeros(total, np.int32)
    for i, (start, n) in enumerate(zip(cu_seqlens(lengths), lengths)):
        ids[start:start + n] = i
        pos[start:start + n] = np.arange(n)
    return ids, pos


# Segment layouts for the kernels' segment form: (kind, b, sq, sk).
#   padding   each row a prefix of valid tokens (id 0), lengths drawn in
#             [s/3, s] as the reference's generate_random_padding_mask,
#             the rest padding (-1): the BERT path;
#   packed    one row of sequences of mixed lengths (short ones beside
#             long ones, so at sq = 1000 whole query tiles are dead for
#             some key tiles), the same on both sides;
#   packed_qk one row of sequences whose query and key lengths differ,
#             keys up to 2 sk / sq times the queries (causal is top-left
#             inside each);
#   random    ids drawn per token from {-1, 0, 1, 2}: non-contiguous
#             segments, positions arange;
#   allpad    padding layout whose first row is all padding.
def segment_layout(rng: np.random.Generator, kind: str, b: int, sq: int,
                   sk: int):
    """(q_seg, kv_seg, q_pos, kv_pos) int32 numpy arrays, (b, sq) and
    (b, sk)."""
    if kind in ("padding", "allpad"):
        assert sq == sk
        lengths = rng.integers(max(1, sq // 3), sq + 1, size=b)
        if kind == "allpad":
            lengths[0] = 0
        seg = np.where(np.arange(sq)[None] < lengths[:, None], 0,
                       -1).astype(np.int32)
        pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq))
        return seg, seg.copy(), pos.copy(), pos.copy()
    if kind == "random":
        seg_q = rng.integers(-1, 3, size=(b, sq)).astype(np.int32)
        seg_k = rng.integers(-1, 3, size=(b, sk)).astype(np.int32)
        return (seg_q, seg_k,
                np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy(),
                np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy())
    assert b == 1 and kind in ("packed", "packed_qk")
    lens_q, lens_k = [], []
    while True:  # long (sq/7..sq/2.5) and short (1..sq/25) sequences in turn
        n = int(rng.integers(sq // 7, sq * 2 // 5)) if len(lens_q) % 2 == 0 \
            else int(rng.integers(1, sq // 25 + 2))
        m = n if kind == "packed" else int(rng.integers(1, 2 * n * sk // sq
                                                         + 2))
        if sum(lens_q) + n > sq - 7 or sum(lens_k) + m > sk - 7:
            break
        lens_q.append(n)
        lens_k.append(m)
    q_seg, q_pos = packed_segments(lens_q, sq)
    k_seg, k_pos = packed_segments(lens_k, sk)
    return q_seg[None], k_seg[None], q_pos[None], k_pos[None]
