"""Fused flash attention: the public entry point over the forward and
backward kernels (port of ``flash_attn_tpu/ops/attention.py``
``flash_attention`` and its ``custom_vjp`` cores ``_flash_core`` /
``_flash_core_lse``)."""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels import prng
from flash_attn_tpu_torch.kernels.common import Band, Segments, kernel_operand
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    """Forward kernel K1 with a saved lse; backward kernel K2. Saves q, k,
    v, out, lse, the integer dropout seed and the segments (with the card's
    tile plan, made once by the forward): no RNG state. Differentiable
    through both outputs; the lse cotangent folds into K2's di."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale, dropout_p, seed,
                segments, band):
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=True, dropout_p=dropout_p, seed=seed, segments=segments,
            band=band)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, softmax_scale, dropout_p, seed, segments, band)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, softmax_scale, dropout_p, seed, segments, band = ctx.args
        # dout is a view of the caller's (b, s, h, d) gradient, taken in
        # place, or absent when only the lse was used.
        dout = torch.zeros_like(out) if dout is None else kernel_operand(dout)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout, lse, causal=causal,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed,
            dlse=None if dlse is None else dlse.contiguous(),
            segments=segments, band=band)
        return dq, dk, dv, None, None, None, None, None, None


def _parse_window(window_size, causal: bool):
    """``window_size`` as (left, right), each None (unbounded) or >= 0
    (JAX ``ops/attention.py:76``): None or -1 is unbounded, a negative value
    raises, and under causal masking a right bound is dropped (causality
    already holds j <= i)."""
    if window_size is None:
        return None, None
    try:
        left, right = window_size
    except (TypeError, ValueError):
        raise ValueError(f"window_size must be a (left, right) pair, got "
                         f"{window_size!r}") from None

    def norm(x, name):
        if x is None or x == -1:
            return None
        x = int(x)
        if x < 0:
            raise ValueError(f"window_size {name} must be >= 0, None, or -1 "
                             f"(unbounded); got {x}")
        return x

    left, right = norm(left, "left"), norm(right, "right")
    if causal and right is not None:
        right = None
    return left, right


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """The standard ALiBi geometric slope schedule (Press et al. 2022; JAX
    ``ops/attention.py:113``): for power-of-two head counts slope_i =
    2^(-8(i+1)/n); otherwise the paper's interpolation (the closest power
    of two plus every other slope of the doubled schedule). Returns
    (n_heads,) fp32 on the CPU, ready for ``flash_attention(alibi_slopes=
    ...)``."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2(closest) + pow2(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(s, dtype=torch.float32)


def _norm_alibi(slopes, b: int, h: int, softmax_scale: float, device):
    """Slopes (h,) or (b, h) as (b, h) fp32 on ``device``, divided by the
    softmax scale so the kernels add the bias to the score before the scale
    (JAX ``ops/attention.py:133`` ``_norm_alibi``); None without slopes."""
    if slopes is None:
        return None
    a = torch.as_tensor(slopes, dtype=torch.float32, device=device)
    if tuple(a.shape) == (h,):
        a = a[None].expand(b, h)
    elif tuple(a.shape) != (b, h):
        raise ValueError(f"alibi_slopes must have shape ({h},) or ({b}, {h});"
                         f" got {tuple(a.shape)}")
    return (a / torch.tensor(softmax_scale, dtype=torch.float32)).contiguous()


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

    ``window_size`` ((left, right), None or -1 unbounded): key j is
    visible from query i iff i - left <= j <= i + right (positions with
    segment ids, global indices otherwise); ``causal=True, window_size=
    (4095, 0)`` is Mistral's local causal attention. ``num_sinks`` (with a
    band, without segments) keeps the first N key columns visible.
    ``alibi_slopes`` ((h,) or (b, h) fp32, e.g. ``alibi_slopes(h)``) adds
    slope * (j - i) under causal masking and -slope * |i - j| otherwise.
    ``softcap`` (> 0) caps the scaled scores as ``softcap * tanh(s /
    softcap)`` before the ALiBi bias and the mask. The kernels skip the
    tiles outside the band.

    Differentiable in q, k and v (through both outputs with ``return_lse``)
    when grad is enabled and an input requires it; otherwise the forward
    runs alone and skips the lse. ``window_cell`` and ``qk_quant`` raise
    NotImplementedError naming the ROADMAP item that ports them.
    """
    for name, is_set, item in (
        ("window_cell", window_cell is not None,
         "M4b (window_cell and the blocksparse band route)"),
        ("qk_quant", qk_quant is not None, "M8 (int8 QK, K9)"),
    ):
        if is_set:
            raise NotImplementedError(
                f"flash_attention({name}=...) is ROADMAP port item {item}")
    if softcap is not None and softcap <= 0.0:
        raise ValueError(f"softcap must be > 0, got {softcap}")

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
    window_left, window_right = _parse_window(window_size, causal)
    if num_sinks:
        if segments is not None:
            raise ValueError("num_sinks does not compose with segment ids "
                             "(it compares global indices, not positions)")
        if window_left is None and window_right is None:
            raise ValueError("num_sinks requires a window_size band")
        if num_sinks < 0:
            raise ValueError(f"num_sinks must be >= 0, got {num_sinks}")
    if segments is None:
        # Without segments a band covering every (i, j) pair is the
        # unwindowed kernel (JAX ops/attention.py:629-642).
        if window_left is not None and window_left >= sq - 1:
            window_left = None
        if window_right is not None and window_right >= sk - 1:
            window_right = None
        if window_left is None and window_right is None:
            num_sinks = 0
    band = Band(window_left, window_right, int(num_sinks),
                None if softcap is None else float(softcap),
                _norm_alibi(alibi_slopes, b, h, softmax_scale, q.device))

    # The kernels take (b, h, s, d) views with 16-byte row strides in place
    # (views of a packed qkv included); only misaligned rows are copied.
    if layout == "bshd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    q, k, v = kernel_operand(q), kernel_operand(k), kernel_operand(v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, causal, softmax_scale,
                                         dropout_p, seed, segments, band)
    else:
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            save_lse=return_lse, dropout_p=dropout_p, seed=seed,
            segments=segments, band=band)
    if layout == "bshd":
        out = out.transpose(1, 2)
    return (out, lse) if return_lse else out
