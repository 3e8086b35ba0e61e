"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain-torch twin.

Replaces the Pallas kernel ``flash_attn_tpu/kernels/flash_fwd.py``
``_fwd_kernel`` (launcher ``flash_attention_fwd``). Kernel layout: q
(b, h, sq, d), k and v (b, h_kv, sk, d); returns out (b, h, sq, d) in the
q dtype and, with ``save_lse``, the fp32 logsumexp (b, h, sq). Causal
masking is top-left aligned; rows with no visible key give out = 0 and
lse = -inf.
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels import _build

HEAD_DIMS = (64, 128)


def flash_attention_fwd(q, k, v, *, causal: bool, softmax_scale: float,
                        save_lse: bool):
    """Forward attention. A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel or raises. Returns ``(out, lse)``; ``lse`` is None
    unless ``save_lse``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=save_lse,
        )
    b, h, sq, d = q.shape
    _, h_kv, sk, _ = k.shape
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; need one of fp32, fp16, bf16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if k.shape != (b, h_kv, sk, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"flash_attention_fwd: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _build.require_cuda("flash_attention_fwd", q, k, v)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention_fwd: q/k/v data must be 16-byte "
                         "aligned (the kernel loads 16-byte vectors)")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    lib = _build.lib()
    code = lib.fattn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, h, h_kv, sq, sk, d, float(softmax_scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device),
    )
    flash_attention_fwd.launches += 1
    _build.check(code, "fattn_flash_fwd")
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_plain(q, k, v, *, causal: bool, softmax_scale: float,
                              save_lse: bool):
    """Plain-torch twin of the kernel: fp32 scores, top-left causal mask,
    GQA by repeating kv heads, out = 0 and lse = -inf on empty rows."""
    h, h_kv = q.shape[1], k.shape[1]
    sq, sk = q.shape[2], k.shape[2]
    kf = k.float().repeat_interleave(h // h_kv, dim=1)
    vf = v.float().repeat_interleave(h // h_kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * softmax_scale
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)  # empty rows: 0
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return out, (lse if save_lse else None)
