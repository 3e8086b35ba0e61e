"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain-torch twin.

Replaces the Pallas kernel ``flash_attn_tpu/kernels/flash_fwd.py``
``_fwd_kernel`` (launcher ``flash_attention_fwd``). Kernel layout: q
(b, h, sq, d), k and v (b, h_kv, sk, d), each with a contiguous last
dimension and any 16-byte row strides (``kernels/common.py`` ``rows_ok``:
transposed views of (b, s, h, d) tensors or of a packed qkv are read in
place); returns out (b, h, sq, d) in the q dtype (on the card a view of
(b, sq, h, d) memory) and, with ``save_lse``, the fp32 logsumexp
(b, h, sq). Causal masking is top-left aligned; rows with no visible key
give out = 0 and lse = -inf. With ``dropout_p > 0`` the attention weights
are dropped by the coordinate hash of ``kernels/prng.py`` keyed on
``seed``; the lse stays that of the un-dropped scores.

``segments`` (``kernels/common.py`` ``Segments``) gives the segment form
(``_fwd_kernel``'s ``has_segments`` branch there): query i sees key j only
within one non-negative segment id and, under causal masking, where i's
position is at or after j's (causal is top-left inside each segment). On
the card the kernel walks the tile plan of ``segment_plan``: key tiles
with no visible pair are never loaded. The dropout hash keeps the padded
(b, h, row, col) coordinates.

``band`` (``kernels/common.py`` ``Band``, M4) adds the window band (key j
visible from row i iff i - left <= j <= i + right, by positions in the
segment form), sink columns (dense), the logit softcap (``cap * tanh(u /
cap)`` on the scaled score u) and ALiBi (slope * (j - i) under causal
masking, -slope * |i - j| otherwise, after the softcap, before the mask).
On the card the kernel walks only the band's key tiles and the sink tiles.
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels import _build, prng
from flash_attn_tpu_torch.kernels.common import (
    NO_BAND,
    Band,
    Segments,
    band_distance,
    band_mask,
    check_rows,
    empty_rows,
    segment_mask,
    segment_plan,
    strides_arg,
)

HEAD_DIMS = (64, 128)
# The bf16/fp16 kernel's tile: query rows per block, keys per K/V tile
# (csrc/flash_fwd.cu kBlockM, kBlockN).
BLOCK_M, BLOCK_N = 128, 128


def dropout_args(dropout_p: float, seed) -> tuple[int, int, float]:
    """(seed, threshold, 1 / (1 - p)) as the kernels take them."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p == 0.0:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    return (prng.seed_value(seed), prng.dropout_threshold(dropout_p),
            1.0 / (1.0 - dropout_p))


def check_kernel_inputs(name, q, k, v, softmax_scale):
    """Dtype, head_dim, shape, scale, device and row-stride checks the
    attention kernels share."""
    b, h, _, d = q.shape
    _, h_kv, sk, _ = k.shape
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "need one of fp32, fp16, bf16")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, h_kv, sk, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not softmax_scale > 0:
        raise ValueError(f"{name}: softmax_scale {softmax_scale}, need > 0")
    _build.require_device(name, q, k, v)
    check_rows(name, q, k, v)


def band_arg(name, band: Band, q, segments) -> Band:
    """``band`` checked against the call: sinks need a band and the dense
    form, the softcap is positive, slopes are (b, h) fp32 contiguous on the
    tensors' device."""
    b, h = q.shape[0], q.shape[1]
    if band.sinks < 0 or (band.sinks and (segments is not None
                                          or not band.windowed)):
        raise ValueError(f"{name}: sinks {band.sinks} need a window band "
                         "and no segments")
    if band.softcap is not None and not band.softcap > 0:
        raise ValueError(f"{name}: softcap {band.softcap}, need > 0")
    for side in (band.left, band.right):
        if side is not None and side < 0:
            raise ValueError(f"{name}: window side {side}, need >= 0")
    a = band.alibi
    if a is not None and (a.shape != (b, h) or a.dtype != torch.float32
                          or a.device != q.device or not a.is_contiguous()):
        raise ValueError(f"{name}: alibi {a.dtype} {tuple(a.shape)}, need "
                         f"fp32 contiguous {(b, h)} on {q.device}")
    return band


def plan_arg(name, segments: Segments | None, q, k, causal: bool,
             band: Band = NO_BAND):
    """The card's tile plan of ``segments`` (made here if the caller has
    none), checked against the call's shapes; None without segments."""
    if segments is None:
        return None
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    for x, s in ((segments.q_seg, sq), (segments.q_pos, sq),
                 (segments.kv_seg, sk), (segments.kv_pos, sk)):
        if x.shape != (b, s) or x.dtype != torch.int32:
            raise ValueError(f"{name}: segment ids/positions {x.dtype} "
                             f"{tuple(x.shape)}, need int32 {(b, s)}")
    if segments.plan is None:
        segment_plan(segments, causal, band)
    return segments.plan


def flash_attention_fwd(q, k, v, *, causal: bool, softmax_scale: float,
                        save_lse: bool, dropout_p: float = 0.0, seed=None,
                        segments: Segments | None = None,
                        band: Band = NO_BAND):
    """Forward attention. A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel or raises. Returns ``(out, lse)``; ``lse`` is None
    unless ``save_lse``."""
    seed_u32, threshold, rp = dropout_args(dropout_p, seed)
    band = band_arg("flash_attention_fwd", band, q, segments)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=save_lse, dropout_p=dropout_p, seed=seed,
            segments=segments, band=band,
        )
    check_kernel_inputs("flash_attention_fwd", q, k, v, softmax_scale)
    plan = plan_arg("flash_attention_fwd", segments, q, k, causal, band)
    b, h, sq, d = q.shape
    _, h_kv, sk, _ = k.shape
    out = empty_rows(b, h, sq, q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    code = _build.lib().fattn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        strides_arg(q=q, k=k, v=v, o=out),
        plan.data_ptr() if plan is not None else None,
        b, h, h_kv, sq, sk, d, float(softmax_scale), int(causal),
        seed_u32, threshold, rp, *band.args(),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device),
    )
    flash_attention_fwd.launches += 1
    _build.check(code, "fattn_flash_fwd")
    return out, lse


_build.counter(flash_attention_fwd)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain twins compute in fp32, or in fp64 for fp64 inputs (which
    lets ``torch.autograd.gradcheck`` run on them)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def scores_plain(q, k, *, causal: bool, softmax_scale: float,
                 segments: Segments | None = None, band: Band = NO_BAND,
                 with_gate: bool = False):
    """Scaled scores (b, h, sq, sk) with GQA by repeated kv heads, the
    band's softcap and ALiBi, and the top-left causal mask (or the segment
    mask) and the band as -inf, in the compute dtype. ``with_gate`` also
    returns the softcap's derivative 1 - tanh^2 (None without a softcap)."""
    ct = compute_dtype(q)
    sq, sk = q.shape[2], k.shape[2]
    kf = k.to(ct).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf)
    gate = None
    if band.softcap is not None or band.alibi is not None:
        # In pre-scale units, as the kernels carry the score
        # (flash_fwd.py:241-284 there).
        if band.softcap is not None:
            th = torch.tanh(s * (softmax_scale / band.softcap))
            s = th * (band.softcap / softmax_scale)
            gate = 1.0 - th * th
        if band.alibi is not None:
            dist = band_distance(causal, sq, sk, q.device, segments)
            s = s + band.alibi.to(ct)[:, :, None, None] * dist.to(ct)
    s = s * softmax_scale
    if segments is not None:
        s = s.masked_fill(~segment_mask(segments, causal), -math.inf)
    elif causal:
        visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, -math.inf)
    inside = band_mask(band, sq, sk, q.device, segments)
    if inside is not None:
        s = s.masked_fill(~inside, -math.inf)
    return (s, gate) if with_gate else s


def keep_plain(q, k, dropout_p: float, seed):
    """The dense keep mask (b, h, sq, sk) the kernels regenerate."""
    b, h, sq, _ = q.shape
    return prng.dropout_mask_dense(seed, b, h, sq, k.shape[2], dropout_p,
                                   device=q.device)


def flash_attention_fwd_plain(q, k, v, *, causal: bool, softmax_scale: float,
                              save_lse: bool, dropout_p: float = 0.0,
                              seed=None, segments: Segments | None = None,
                              band: Band = NO_BAND):
    """Plain-torch twin of the kernel: fp32 scores, top-left causal mask
    (or the segment mask) and the band, GQA by repeating kv heads, out = 0
    and lse = -inf on empty rows, dropout after the softmax rescaled by
    1 / (1 - p)."""
    _, _, rp = dropout_args(dropout_p, seed)
    ct = compute_dtype(q)
    s = scores_plain(q, k, causal=causal, softmax_scale=softmax_scale,
                     segments=segments, band=band)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)  # empty rows: 0
    if dropout_p > 0.0:
        p = torch.where(keep_plain(q, k, dropout_p, seed), p, 0.0) * rp
    vf = v.to(ct).repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return out, (lse if save_lse else None)
