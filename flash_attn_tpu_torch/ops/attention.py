"""Fused flash attention: the public entry point over the forward and
backward kernels (port of ``flash_attn_tpu/ops/attention.py``
``flash_attention`` and its ``custom_vjp`` cores ``_flash_core`` /
``_flash_core_lse``)."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.kernels import prng
from flash_attn_tpu_torch.kernels.common import Segments, kernel_operand
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    """Forward kernel K1 with a saved lse; backward kernel K2. Saves q, k,
    v, out, lse, the integer dropout seed and the segments (with the card's
    tile plan, made once by the forward): no RNG state. Differentiable
    through both outputs; the lse cotangent folds into K2's di."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale, dropout_p, seed,
                segments):
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=True, dropout_p=dropout_p, seed=seed, segments=segments)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, softmax_scale, dropout_p, seed, segments)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, softmax_scale, dropout_p, seed, segments = ctx.args
        # dout is a view of the caller's (b, s, h, d) gradient, taken in
        # place, or absent when only the lse was used.
        dout = torch.zeros_like(out) if dout is None else kernel_operand(dout)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout, lse, causal=causal,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed,
            dlse=None if dlse is None else dlse.contiguous(),
            segments=segments)
        return dq, dk, dv, None, None, None, None, None


def _segments(q_segment_ids, kv_segment_ids, q_positions, kv_positions,
              b, sq, sk, device):
    """The four (b, s) vectors as int32 on the tensors' device, positions
    defaulting to arange (JAX ``ops/attention.py:644-651``); None without
    segment ids. As in JAX, positions alone (without ids) are ignored."""
    if q_segment_ids is None:
        return None
    if kv_segment_ids is None:
        raise ValueError("q_segment_ids requires kv_segment_ids")

    def vec(x, s, name):
        if x is None:
            x = torch.arange(s, device=device).expand(b, s)
        x = torch.as_tensor(x, device=device)
        if tuple(x.shape) != (b, s):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, need {(b, s)}")
        return x.to(torch.int32).contiguous()

    return Segments(vec(q_segment_ids, sq, "q_segment_ids"),
                    vec(kv_segment_ids, sk, "kv_segment_ids"),
                    vec(q_positions, sq, "q_positions"),
                    vec(kv_positions, sk, "kv_positions"))


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

    ``layout``: "bshd" (default; passed to the kernels as transposed views)
    or "bhsd" (the kernels' index order). On the card the output lies in
    (b, s, h, d) memory whatever the layout. GQA/MQA: k/v may carry fewer heads
    than q (a multiple). ``causal`` is top-left aligned when sq != sk.
    ``return_lse`` also returns the fp32 (b, h, sq) logsumexp. Out is in the
    q dtype; rows with no visible key give out = 0 and lse = -inf.

    ``dropout_p`` drops attention weights after the softmax; it requires
    ``dropout_seed`` (an int or a 0-dim integer tensor), and the same seed
    gives the same mask in the forward and the backward, on any tiling.

    ``q_segment_ids`` / ``kv_segment_ids`` ((b, sq) / (b, sk) int, -1 =
    padding): tokens attend only within equal non-negative ids; with
    ``q_positions`` / ``kv_positions`` (per-segment local positions,
    default arange) causal compares positions, so it is top-left inside
    each segment. Rows with no visible key give out = 0 and lse = -inf. The
    dropout mask keeps the (b, h, row, col) coordinates of the padded
    layout.

    Differentiable in q, k and v (through both outputs with ``return_lse``)
    when grad is enabled and an input requires it; otherwise the forward
    runs alone and skips the lse. The other arguments of the JAX signature
    raise NotImplementedError naming the item that ports them.
    """
    # Arguments of the JAX signature that the port does not run yet, each
    # with the ROADMAP queue item that brings it.
    for name, is_set, item in (
        ("window_size", window_size is not None, "M4 (window/ALiBi/...)"),
        ("alibi_slopes", alibi_slopes is not None, "M4 (window/ALiBi/...)"),
        ("softcap", softcap is not None, "M4 (window/ALiBi/softcap/...)"),
        ("num_sinks", num_sinks != 0, "M4 (window/sinks/band routing)"),
        ("window_cell", window_cell is not None,
         "M4 (window/sinks/band routing)"),
        ("qk_quant", qk_quant is not None, "M8 (int8 QK, K9)"),
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
    segments = _segments(q_segment_ids, kv_segment_ids, q_positions,
                         kv_positions, b, sq, sk, q.device)

    # The kernels take (b, h, s, d) views with 16-byte row strides in place
    # (views of a packed qkv included); only misaligned rows are copied.
    if layout == "bshd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    q, k, v = kernel_operand(q), kernel_operand(k), kernel_operand(v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, causal, softmax_scale,
                                         dropout_p, seed, segments)
    else:
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=return_lse, dropout_p=dropout_p, seed=seed,
            segments=segments)
    if layout == "bshd":
        out = out.transpose(1, 2)
    return (out, lse) if return_lse else out
