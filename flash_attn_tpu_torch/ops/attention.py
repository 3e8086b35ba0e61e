"""Fused flash attention: the public entry point over the forward kernel
(port of ``flash_attn_tpu/ops/attention.py`` ``flash_attention``)."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd


def flash_attention(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, h_kv, d)
    v: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: float | None = None,
    return_lse: bool = False,
    layout: str = "bshd",
    dropout_p: float = 0.0,
    dropout_seed=None,
    window_size=None,
    alibi_slopes=None,
    softcap: float | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    q_positions=None,
    kv_positions=None,
    qk_quant: str | None = None,
    num_sinks: int = 0,
    window_cell=None,
):
    """O = softmax(scale * Q K^T + mask) V, exact, without materialising
    the scores.

    ``layout``: "bshd" (default; transposed to the kernel layout here) or
    "bhsd" (the kernel-native layout). GQA/MQA: k/v may carry fewer heads
    than q (a multiple). ``causal`` is top-left aligned when sq != sk.
    ``return_lse`` also returns the fp32 (b, h, sq) logsumexp. Out is in the
    q dtype; rows with no visible key give out = 0 and lse = -inf.

    Forward only: on a CUDA tensor that requires grad this raises, since the
    backward kernel (K2) is ROADMAP port item P1. The other arguments of the
    JAX signature raise NotImplementedError naming the item that ports them.
    """
    # Arguments of the JAX signature that the port does not run yet, each
    # with the ROADMAP port item that brings it.
    for name, is_set, item in (
        ("dropout_p", dropout_p != 0.0, "P1 (backward + dropout)"),
        ("dropout_seed", dropout_seed is not None, "P1 (backward + dropout)"),
        ("window_size", window_size is not None, "P2 (window/ALiBi/...)"),
        ("alibi_slopes", alibi_slopes is not None, "P2 (window/ALiBi/...)"),
        ("softcap", softcap is not None, "P2 (window/ALiBi/softcap/...)"),
        ("q_segment_ids", q_segment_ids is not None, "P2 (.../segments)"),
        ("kv_segment_ids", kv_segment_ids is not None, "P2 (.../segments)"),
        ("q_positions", q_positions is not None, "P2 (.../segments)"),
        ("kv_positions", kv_positions is not None, "P2 (.../segments)"),
        ("num_sinks", num_sinks != 0, "P9 (blocksparse band routing)"),
        ("window_cell", window_cell is not None, "P9 (blocksparse)"),
        ("qk_quant", qk_quant is not None, "P11 (int8 QK, K9)"),
    ):
        if is_set:
            raise NotImplementedError(
                f"flash_attention({name}=...) is ROADMAP port item {item}")
    if q.device.type == "cuda" and torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward on CUDA yet (kernel K2, ROADMAP "
            "port item P1): call it under torch.no_grad() or detach inputs")

    if layout == "bshd":
        b, sq, h, d = q.shape
        sk, h_kv = k.shape[1], k.shape[2]
        kv_shape = (b, sk, h_kv, d)
    elif layout == "bhsd":
        b, h, sq, d = q.shape
        h_kv, sk = k.shape[1], k.shape[2]
        kv_shape = (b, h_kv, sk, d)
    else:
        raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape \
            or h % max(h_kv, 1):
        raise ValueError(
            f"q/k/v shape mismatch: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)} (GQA/MQA requires q heads to be a multiple "
            "of kv heads)")
    if softmax_scale is None:
        softmax_scale = d ** -0.5

    if layout == "bshd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        softmax_scale=softmax_scale, save_lse=return_lse,
    )
    if layout == "bshd":
        out = out.transpose(1, 2)
    return (out, lse) if return_lse else out
