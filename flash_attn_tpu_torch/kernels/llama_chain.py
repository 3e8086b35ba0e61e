"""The elementwise chain of the Llama serving phases as three kernels
(``csrc/llama_chain.cu``), with their plain-torch twins.

- ``add_rmsnorm(x, d, weight, eps)``: the residual add and the RMSNorm
  after it, ``(x + d, rmsnorm(x + d) * weight)``; without ``d`` the norm
  of x alone. The serving phases (``models/llama_decode.py``) carry each
  layer's pending sublayer output ``d`` to the next norm, so one launch
  is the post-attention add and norm, and one the MLP's add and the next
  layer's input norm (or the final norm).
- ``qk_rope(q, k, positions, inv_freq, q_norm, k_norm, eps)``: the
  optional per-head RMSNorm of q and k (Qwen3's QK-norm), then rotary in
  the HF half-split layout at each token's position, IN PLACE on q (b, s,
  n_head, hd) and k (b, s, n_kv_head, hd). cos and sin come from the
  positions inside the kernel: no per-layer tables.
- ``swiglu(gate, up)``: ``silu(gate) * up``; gate and up are rows with a
  contiguous last dimension, the dense MLP's two products or the two
  strided halves of the routed experts' fused product.

Numerics are the flax model's: statistics, rotary and the activation in
fp32, one rounding to the activation dtype at the end, and the residual
sum rounded first, as ``x + d`` rounds it (``csrc/llama_chain.cu``). The
kernels are forward-only: every wrapper raises when autograd would need a
backward (grad enabled and an input requiring grad), so the training path
(``LlamaBlock.forward``) keeps the plain modules. A CPU tensor runs the
twin (the plain ops of ``models/llama.py``, unchanged); a CUDA tensor the
kernel, or the wrapper raises. Each wrapper counts its ``launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flash_attn_tpu_torch.kernels import _build


def _forward_only(name, *tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: forward-only kernel, called on an input "
                           "that requires grad")


def _dtype_code(name, t):
    code = _build.DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {t.dtype} is not supported")
    return code


def _rows(name, x):
    """x (..., n) as (rows, n) with a contiguous last dimension."""
    r = x.reshape(-1, x.shape[-1])
    if r.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension of {tuple(x.shape)} is "
                         "not contiguous")
    return r


# ------------------------------------------------------------ plain twins


def rms_norm_plain(x, weight, eps, out_dtype):
    """x / rms(x) * weight over the last dimension, statistics in fp32,
    cast to ``out_dtype`` (``models/llama.py`` ``RMSNorm``)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(out_dtype)


def add_rmsnorm_plain(x, d, weight, eps):
    """Plain-torch twin of ``add_rmsnorm``."""
    s = x if d is None else x + d
    return s, rms_norm_plain(s, weight, eps, s.dtype)


def rope_inv_freq(dim: int, base: float, device):
    """fp32 inverse frequencies (dim // 2,) of rotary over ``dim``."""
    return 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))


def rope_tables(positions, inv_freq):
    """fp32 cos/sin of shape positions.shape + (dim,), half-split layout."""
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_llama_rope(x, cos, sin):
    """x (b, s, h, d); cos/sin (s, d) or (b, s, d). Rotates in fp32 and
    returns x's dtype."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None], sin[:, :, None]  # (b, s, 1, d)
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


def qk_rope_plain(q, k, positions, inv_freq, q_norm=None, k_norm=None,
                  eps=0.0):
    """Plain-torch twin of ``qk_rope`` (in place)."""
    qn, kn = q, k
    if q_norm is not None:
        qn = rms_norm_plain(q, q_norm, eps, q.dtype)
        kn = rms_norm_plain(k, k_norm, eps, k.dtype)
    cos, sin = rope_tables(positions, inv_freq)
    q.copy_(apply_llama_rope(qn, cos, sin))
    k.copy_(apply_llama_rope(kn, cos, sin))
    return q, k


def swiglu_plain(gate, up):
    """Plain-torch twin of ``swiglu``."""
    return F.silu(gate) * up


# --------------------------------------------------------------- kernels


def add_rmsnorm(x, d, weight, eps: float):
    """``(x + d, rmsnorm(x + d) * weight)`` in x's dtype, one launch; with
    ``d`` None, ``(x, rmsnorm(x) * weight)``. x and d (..., n) of one
    dtype and shape, rows with a contiguous last dimension; weight (n,)."""
    _forward_only("add_rmsnorm", x, d, weight)
    if x.device.type == "cpu":
        return add_rmsnorm_plain(x, d, weight, eps)
    n = x.shape[-1]
    if d is not None and (d.shape != x.shape or d.dtype != x.dtype):
        raise ValueError(f"add_rmsnorm: d {tuple(d.shape)} {d.dtype} against "
                         f"x {tuple(x.shape)} {x.dtype}")
    if weight.shape != (n,) or not weight.is_contiguous():
        raise ValueError(f"add_rmsnorm: weight {tuple(weight.shape)} for "
                         f"rows of {n}")
    _build.require_device("add_rmsnorm", x, weight,
                          *(() if d is None else (d,)))
    xr = _rows("add_rmsnorm", x)
    dr = None if d is None else _rows("add_rmsnorm", d)
    res = None if d is None else torch.empty(x.shape, dtype=x.dtype,
                                             device=x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    code = _build.lib().fattn_add_rmsnorm(
        xr.data_ptr(), None if dr is None else dr.data_ptr(),
        weight.data_ptr(), None if res is None else res.data_ptr(),
        out.data_ptr(), xr.stride(0), 0 if dr is None else dr.stride(0),
        xr.shape[0], n, eps, _dtype_code("add_rmsnorm", x),
        _dtype_code("add_rmsnorm", weight), _build.stream_ptr(x.device))
    add_rmsnorm.launches += 1
    _build.check(code, "fattn_add_rmsnorm")
    return (x if res is None else res), out


_build.counter(add_rmsnorm)


def qk_rope(q, k, positions, inv_freq, q_norm=None, k_norm=None,
            eps: float = 0.0):
    """QK-norm (with ``q_norm`` / ``k_norm`` (hd,) weights) then rotary at
    ``positions`` (b, s) int64, IN PLACE on q (b, s, n_head, hd) and k (b,
    s, n_kv_head, hd), one launch; returns (q, k). ``inv_freq`` (hd // 2,)
    fp32 (``rope_inv_freq``). q and k may be strided views with hd
    contiguous."""
    _forward_only("qk_rope", q, k, q_norm, k_norm)
    if (q_norm is None) != (k_norm is None):
        raise ValueError("qk_rope: QK-norm needs both weights")
    if q.device.type == "cpu":
        return qk_rope_plain(q, k, positions, inv_freq, q_norm, k_norm, eps)
    b, s, hq, hd = q.shape
    hk = k.shape[2]
    if k.shape != (b, s, hk, hd) or k.dtype != q.dtype \
            or q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError(f"qk_rope: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, hd contiguous")
    if positions.shape != (b, s) or positions.dtype != torch.int64:
        raise ValueError(f"qk_rope: positions {tuple(positions.shape)} "
                         f"{positions.dtype}, need ({b}, {s}) int64")
    if inv_freq.shape != (hd // 2,) or inv_freq.dtype != torch.float32 \
            or not inv_freq.is_contiguous():
        raise ValueError(f"qk_rope: inv_freq {tuple(inv_freq.shape)} "
                         f"{inv_freq.dtype}, need ({hd // 2},) fp32")
    norms = () if q_norm is None else (q_norm, k_norm)
    for w in norms:
        if w.shape != (hd,) or w.dtype != q_norm.dtype \
                or not w.is_contiguous():
            raise ValueError(f"qk_rope: norm weight {tuple(w.shape)}")
    _build.require_device("qk_rope", q, k, positions, inv_freq, *norms)
    code = _build.lib().fattn_qk_rope(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        positions.data_ptr(), *positions.stride(), inv_freq.data_ptr(),
        None if q_norm is None else q_norm.data_ptr(),
        None if k_norm is None else k_norm.data_ptr(), b, s, hq, hk, hd,
        eps, _dtype_code("qk_rope", q),
        _dtype_code("qk_rope", q if q_norm is None else q_norm),
        _build.stream_ptr(q.device))
    qk_rope.launches += 1
    _build.check(code, "fattn_qk_rope")
    return q, k


_build.counter(qk_rope)


def swiglu(gate, up):
    """``silu(gate) * up`` in their dtype, one launch. gate and up (...,
    n) of one shape and dtype, rows with a contiguous last dimension (the
    halves of a fused (rows, 2 n) product are taken as they are)."""
    _forward_only("swiglu", gate, up)
    if gate.device.type == "cpu":
        return swiglu_plain(gate, up)
    if up.shape != gate.shape or up.dtype != gate.dtype:
        raise ValueError(f"swiglu: gate {tuple(gate.shape)} {gate.dtype}, "
                         f"up {tuple(up.shape)} {up.dtype}")
    _build.require_device("swiglu", gate, up)
    g, u = _rows("swiglu", gate), _rows("swiglu", up)
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    code = _build.lib().fattn_swiglu(
        g.data_ptr(), u.data_ptr(), out.data_ptr(), g.stride(0), u.stride(0),
        g.shape[0], g.shape[1], _dtype_code("swiglu", gate),
        _build.stream_ptr(gate.device))
    swiglu.launches += 1
    _build.check(code, "fattn_swiglu")
    return out


_build.counter(swiglu)
