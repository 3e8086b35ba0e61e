"""Flash-attention backward: the CUDA kernel ``csrc/flash_bwd.cu`` and its
plain-torch twin.

Replaces the Pallas kernel ``flash_attn_tpu/kernels/flash_bwd.py``
``_fused_kernel`` (launcher ``flash_attention_bwd``). From the forward's
inputs, its output, the cotangent ``dout`` and the saved fp32 lse it
recomputes the probabilities and returns ``(dq, dk, dv)`` in the input
dtypes, dk/dv at the kv-head shape (GQA groups summed in fp32 inside the
kernel). The dropout mask is regenerated from ``seed``. ``dlse``, the
cotangent of the lse output, folds into the ``di`` correction as
``di - dlse``: since dS uses the pre-dropout p, d(lse)/d(s) * g = g * p is
exactly that term (flash_bwd.py:465-470 there).

Operands as the forward's: any 16-byte row strides; dq, dk and dv come
back as (b, h, s, d) views of (b, s, h, d) memory on the card. dQ
accumulates in fp32 across the key tiles' blocks in a fixed order (a turn
counter per 16-row slice), so dq, like dk and dv, is bitwise reproducible
from run to run.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.common import (
    NO_BAND,
    Band,
    Segments,
    check_rows,
    empty_rows,
    strides_arg,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    band_arg,
    check_kernel_inputs,
    compute_dtype,
    dropout_args,
    keep_plain,
    plan_arg,
    scores_plain,
)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool,
                        softmax_scale: float, dropout_p: float = 0.0,
                        seed=None, dlse=None,
                        segments: Segments | None = None,
                        band: Band = NO_BAND):
    """Gradients of attention. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel or raises. Layout as the forward kernel's:
    q, out, dout (b, h, sq, d); k, v (b, h_kv, sk, d); lse, dlse (b, h, sq)
    fp32 contiguous. ``segments`` and ``band``: the forward's (its tile
    plan is reused when it has one). The softcap's chain rule multiplies
    dS by 1 - tanh^2; the ALiBi bias carries no gradient."""
    seed_u32, threshold, rp = dropout_args(dropout_p, seed)
    band = band_arg("flash_attention_bwd", band, q, segments)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, out, dout, lse, causal=causal,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed,
            dlse=dlse, segments=segments, band=band,
        )
    check_kernel_inputs("flash_attention_bwd", q, k, v, softmax_scale)
    plan = plan_arg("flash_attention_bwd", segments, q, k, causal, band)
    b, h, sq, d = q.shape
    _, h_kv, sk, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_bwd: out {out.dtype} {tuple(out.shape)}, dout "
            f"{dout.dtype} {tuple(dout.shape)} for q {q.dtype} "
            f"{tuple(q.shape)}")
    stats = (lse,) if dlse is None else (lse, dlse)
    for x in stats:
        if x.shape != (b, h, sq) or x.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: lse/dlse {x.dtype} "
                             f"{tuple(x.shape)}, need fp32 {(b, h, sq)}")
    _build.require_device("flash_attention_bwd", q, out, dout, *stats)
    _build.require_cuda("flash_attention_bwd", *stats)  # contiguous rows
    check_rows("flash_attention_bwd", out, dout)
    # Scratch: per query row {lse in the log2 domain, di, the dropout row
    # hash, 0}, rows padded to a multiple of 64; the fp32 dq sums followed
    # by an int32 turn counter per 16-row slice (the kernel zeroes both).
    stats = torch.empty((b, h, -(-sq // 64) * 64, 4), dtype=torch.float32,
                        device=q.device)
    dq_acc = torch.empty(b * h * (sq * d + -(-sq // 16)),
                         dtype=torch.float32, device=q.device)
    dq = empty_rows(b, h, sq, q)
    dk, dv = empty_rows(b, h_kv, sk, k), empty_rows(b, h_kv, sk, v)
    code = _build.lib().fattn_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        dlse.data_ptr() if dlse is not None else None,
        stats.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        strides_arg(q=q, k=k, v=v, o=out, dout=dout, dk=dk, dv=dv, dq=dq),
        plan.data_ptr() if plan is not None else None, b, h, h_kv, sq, sk, d, float(softmax_scale),
        int(causal), seed_u32, threshold, rp, *band.args(),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device),
    )
    flash_attention_bwd.launches += 1
    _build.check(code, "fattn_flash_bwd")
    return dq, dk, dv


_build.counter(flash_attention_bwd)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool,
                              softmax_scale: float, dropout_p: float = 0.0,
                              seed=None, dlse=None,
                              segments: Segments | None = None,
                              band: Band = NO_BAND):
    """Plain-torch twin of the kernel, in fp32 (fp64 for fp64 inputs):
    p = exp(s - lse) (0 where masked, by causality, segments or the band,
    or where lse = -inf), dV from the dropped p, dS = p * (dP - di) * gate
    from the pre-dropout p (gate: the softcap's 1 - tanh^2, else 1), GQA
    groups summed to the kv heads."""
    _, _, rp = dropout_args(dropout_p, seed)
    ct = compute_dtype(q)
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    group = h // h_kv
    s, gate = scores_plain(q, k, causal=causal, softmax_scale=softmax_scale,
                           segments=segments, band=band, with_gate=True)
    lse = lse.to(ct)
    p = torch.exp(s - lse[..., None])
    p = torch.where(torch.isneginf(s) | torch.isneginf(lse)[..., None], 0.0, p)
    do, qf = dout.to(ct), q.to(ct)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    pd = p
    if dropout_p > 0.0:
        keep = keep_plain(q, k, dropout_p, seed)
        pd = torch.where(keep, p, 0.0) * rp
        dp = torch.where(keep, dp, 0.0) * rp
    di = (out.to(ct) * do).sum(-1)
    if dlse is not None:
        di = di - dlse.to(ct)
    ds = p * (dp - di[..., None])
    if gate is not None:
        ds = ds * gate
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * softmax_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * softmax_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, do)

    def group_sum(x):
        return x.reshape(b, h_kv, group, sk, d).sum(2)

    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))
