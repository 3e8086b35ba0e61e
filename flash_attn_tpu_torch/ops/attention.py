"""Fused flash attention: the public entry point over the forward and
backward kernels (port of ``flash_attn_tpu/ops/attention.py``
``flash_attention`` and its ``custom_vjp`` cores ``_flash_core`` /
``_flash_core_lse``)."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels import prng
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    """Forward kernel K1 with a saved lse; backward kernel K2. Saves q, k,
    v, out, lse and the integer dropout seed: no RNG state. Differentiable
    through both outputs; the lse cotangent folds into K2's di."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale, dropout_p, seed):
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=True, dropout_p=dropout_p, seed=seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, softmax_scale, dropout_p, seed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, softmax_scale, dropout_p, seed = ctx.args
        # dout may come from the bshd transpose, or be absent when only the
        # lse was used.
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout, lse, causal=causal,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed,
            dlse=None if dlse is None else dlse.contiguous())
        return dq, dk, dv, None, None, None, None


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
    """O = dropout(softmax(scale * Q K^T + mask)) V, exact, without
    materialising the scores.

    ``layout``: "bshd" (default; transposed to the kernel layout here) or
    "bhsd" (the kernel-native layout). GQA/MQA: k/v may carry fewer heads
    than q (a multiple). ``causal`` is top-left aligned when sq != sk.
    ``return_lse`` also returns the fp32 (b, h, sq) logsumexp. Out is in the
    q dtype; rows with no visible key give out = 0 and lse = -inf.

    ``dropout_p`` drops attention weights after the softmax; it requires
    ``dropout_seed`` (an int or a 0-dim integer tensor), and the same seed
    gives the same mask in the forward and the backward, on any tiling.

    Differentiable in q, k and v (through both outputs with ``return_lse``)
    when grad is enabled and an input requires it; otherwise the forward
    runs alone and skips the lse. The other arguments of the JAX signature
    raise NotImplementedError naming the item that ports them.
    """
    # Arguments of the JAX signature that the port does not run yet, each
    # with the ROADMAP port item that brings it.
    for name, is_set, item in (
        ("window_size", window_size is not None, "P2 (window/ALiBi/...)"),
        ("alibi_slopes", alibi_slopes is not None, "P2 (window/ALiBi/...)"),
        ("softcap", softcap is not None, "P2 (window/ALiBi/softcap/...)"),
        ("q_segment_ids", q_segment_ids is not None, "P2 (.../segments)"),
        ("kv_segment_ids", kv_segment_ids is not None, "P2 (.../segments)"),
        ("q_positions", q_positions is not None, "P2 (.../segments)"),
        ("kv_positions", kv_positions is not None, "P2 (.../segments)"),
        ("num_sinks", num_sinks != 0, "P2 (window/sinks/band routing)"),
        ("window_cell", window_cell is not None,
         "P2 (window/sinks/band routing)"),
        ("qk_quant", qk_quant is not None, "P11 (int8 QK, K9)"),
    ):
        if is_set:
            raise NotImplementedError(
                f"flash_attention({name}=...) is ROADMAP port item {item}")

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
    # The kernels' wrappers validate dropout_p against the seed.
    seed = None if dropout_seed is None else prng.seed_value(dropout_seed)
    if softmax_scale is None:
        softmax_scale = d ** -0.5

    if layout == "bshd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, causal, softmax_scale,
                                         dropout_p, seed)
    else:
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=return_lse, dropout_p=dropout_p, seed=seed)
    if layout == "bshd":
        out = out.transpose(1, 2)
    return (out, lse) if return_lse else out
