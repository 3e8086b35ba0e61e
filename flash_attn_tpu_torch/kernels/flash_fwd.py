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
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels import _build, prng
from flash_attn_tpu_torch.kernels.common import (
    check_rows,
    empty_rows,
    strides_arg,
)

HEAD_DIMS = (64, 128)


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


def flash_attention_fwd(q, k, v, *, causal: bool, softmax_scale: float,
                        save_lse: bool, dropout_p: float = 0.0, seed=None):
    """Forward attention. A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel or raises. Returns ``(out, lse)``; ``lse`` is None
    unless ``save_lse``."""
    seed_u32, threshold, rp = dropout_args(dropout_p, seed)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=save_lse, dropout_p=dropout_p, seed=seed,
        )
    check_kernel_inputs("flash_attention_fwd", q, k, v, softmax_scale)
    b, h, sq, d = q.shape
    _, h_kv, sk, _ = k.shape
    out = empty_rows(b, h, sq, q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    code = _build.lib().fattn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        strides_arg(q=q, k=k, v=v, o=out), b, h, h_kv, sq, sk, d, float(softmax_scale), int(causal),
        seed_u32, threshold, rp,
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device),
    )
    flash_attention_fwd.launches += 1
    _build.check(code, "fattn_flash_fwd")
    return out, lse


flash_attention_fwd.launches = 0


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain twins compute in fp32, or in fp64 for fp64 inputs (which
    lets ``torch.autograd.gradcheck`` run on them)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def scores_plain(q, k, *, causal: bool, softmax_scale: float):
    """Scaled scores (b, h, sq, sk) with GQA by repeated kv heads and the
    top-left causal mask as -inf, in the compute dtype."""
    ct = compute_dtype(q)
    kf = k.to(ct).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * softmax_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, -math.inf)
    return s


def keep_plain(q, k, dropout_p: float, seed):
    """The dense keep mask (b, h, sq, sk) the kernels regenerate."""
    b, h, sq, _ = q.shape
    return prng.dropout_mask_dense(seed, b, h, sq, k.shape[2], dropout_p,
                                   device=q.device)


def flash_attention_fwd_plain(q, k, v, *, causal: bool, softmax_scale: float,
                              save_lse: bool, dropout_p: float = 0.0,
                              seed=None):
    """Plain-torch twin of the kernel: fp32 scores, top-left causal mask,
    GQA by repeating kv heads, out = 0 and lse = -inf on empty rows,
    dropout after the softmax rescaled by 1 / (1 - p)."""
    _, _, rp = dropout_args(dropout_p, seed)
    ct = compute_dtype(q)
    s = scores_plain(q, k, causal=causal, softmax_scale=softmax_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)  # empty rows: 0
    if dropout_p > 0.0:
        p = torch.where(keep_plain(q, k, dropout_p, seed), p, 0.0) * rp
    vf = v.to(ct).repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return out, (lse if save_lse else None)
