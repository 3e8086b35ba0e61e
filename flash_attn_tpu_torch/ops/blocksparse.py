"""Blocksparse attention: the public op, its autograd and the
reference-parity API (port of ``flash_attn_tpu/ops/blocksparse.py``).

The (ceil(s/16), ceil(s/256)) 0/1 cell mask expands by repetition to an
element mask over the attention matrix, composed with key padding and
causal masks; rows that see no key give zero output. Forward K8a, backward
K8b (dK, dV) and K8c (dQ), all in ``kernels/blocksparse.py``, for every
layout: the JAX package's band route to its dense window kernel needs
``flash_attention``'s ``window_cell``, and is ROADMAP port item M4b.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from flash_attn_tpu_torch.kernels import prng
from flash_attn_tpu_torch.kernels.blocksparse import (
    COL_CELL,
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    ROW_CELL,
    BlockSparseLayout,
    blocksparse_attention_bwd,
    blocksparse_attention_fwd,
    build_layout,
    convert_blockmask,
    kernel_operand,
)


def expand_blockmask(blockmask, sq: int, sk: int) -> torch.Tensor:
    """The cell mask repeated to an elementwise (sq, sk) bool mask."""
    bm = torch.as_tensor(np.asarray(blockmask)).bool()
    full = bm.repeat_interleave(ROW_CELL, 0).repeat_interleave(COL_CELL, 1)
    return full[:sq, :sk]


class _BlocksparseAttention(torch.autograd.Function):
    """K8a with a saved lse; backward K8b + K8c. Saves q, k, v, out, lse
    and the integer dropout seed. Differentiable through both outputs; the
    lse cotangent folds into di."""

    @staticmethod
    def forward(ctx, q, k, v, layout, q_valid, k_valid, softmax_scale,
                dropout_p, seed):
        out, lse = blocksparse_attention_fwd(
            q, k, v, layout, q_valid, k_valid, softmax_scale=softmax_scale,
            dropout_p=dropout_p, seed=seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (layout, q_valid, k_valid, softmax_scale, dropout_p, seed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        layout, q_valid, k_valid, softmax_scale, dropout_p, seed = ctx.args
        dout = torch.zeros_like(out) if dout is None else kernel_operand(dout)
        dq, dk, dv = blocksparse_attention_bwd(
            q, k, v, out, dout, lse, layout, q_valid, k_valid,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed,
            dlse=None if dlse is None else dlse.contiguous())
        return dq, dk, dv, None, None, None, None, None, None


def blocksparse_attention(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, h, d)
    v: torch.Tensor,
    blockmask,  # (ceil(sq/16), ceil(sk/256)) 0/1, or a BlockSparseLayout
    *,
    causal: bool = False,
    softmax_scale: float | None = None,
    key_padding_mask: torch.Tensor | None = None,  # (b, sk) bool, True = valid
    dropout_p: float = 0.0,
    dropout_seed=None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    return_lse: bool = False,
):
    """Fused blocksparse attention on dense (batch, seq, heads, dim) inputs.

    ``key_padding_mask`` marks valid keys; a query row whose position is
    not a valid key (or lies past sk) sees nothing and gives 0. Head dims
    other than 64 and 128 are zero-padded up to the next of them (d <= 128);
    the softmax scale defaults to the true d ** -0.5. MHA only (k and v have
    q's heads), as in the JAX package. ``dropout_p`` needs ``dropout_seed``;
    the mask is the coordinate hash of ``kernels/prng.py``. ``return_lse``
    also returns the fp32 (b, h, sq) logsumexp (-inf on rows that see
    nothing). Differentiable in q, k and v."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(
            f"blocksparse_attention: shapes {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}; k and v need q's heads "
            "(MHA only)")
    if d > 128:
        raise ValueError(f"blocksparse_attention: head_dim {d} > 128")
    if softmax_scale is None:
        softmax_scale = d ** -0.5

    if isinstance(blockmask, BlockSparseLayout):
        layout = blockmask
        if layout.causal != causal:
            raise ValueError(
                "layout was built with a different `causal` setting")
        if (layout.sq, layout.sk) != (sq, sk):
            raise ValueError(f"layout was built for sq={layout.sq}, "
                             f"sk={layout.sk}; the inputs have {sq}, {sk}")
    else:
        if isinstance(blockmask, torch.Tensor):
            blockmask = blockmask.cpu().numpy()
        layout = build_layout(np.asarray(blockmask), sq=sq, sk=sk,
                              block_q=block_q, block_k=block_k, causal=causal)

    d_pad = 64 if d <= 64 else 128

    def kernel_layout(x):  # (b, s, h, d) -> a (b, h, s, d_pad) view if it can
        x = x.transpose(1, 2)
        if d_pad != d:
            x = F.pad(x, (0, d_pad - d))
        return kernel_operand(x)

    qp, kp, vp = kernel_layout(q), kernel_layout(k), kernel_layout(v)
    q_valid = k_valid = None
    if key_padding_mask is not None:
        k_valid = key_padding_mask.to(q.device, torch.uint8).contiguous()
        n = min(sq, sk)
        q_valid = torch.zeros((b, sq), dtype=torch.uint8, device=q.device)
        q_valid[:, :n] = k_valid[:, :n]
    seed = None if dropout_seed is None else prng.seed_value(dropout_seed)
    scale, p = float(softmax_scale), float(dropout_p)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _BlocksparseAttention.apply(qp, kp, vp, layout, q_valid,
                                               k_valid, scale, p, seed)
    else:
        out, lse = blocksparse_attention_fwd(
            qp, kp, vp, layout, q_valid, k_valid, softmax_scale=scale,
            dropout_p=p, seed=seed)
    out = out[..., :d].transpose(1, 2)
    return (out, lse) if return_lse else out


def flash_blocksparse_attn_func(
    qkv,  # packed (total, 3, h, d) with cu_seqlens, or dense (b, s, 3, h, d)
    cu_seqlens,
    blockmask,
    dropout_p,
    max_s,
    softmax_scale=None,
    causal=False,
    return_attn_probs=False,
    *,
    dropout_seed=None,
    convert_mask=True,  # accepted for API parity; layouts also accepted
):
    """Reference-parity entry point (JAX :261).

    The packed (total, 3, h, d) + cu_seqlens form is re-batched to a dense
    (b, max_s) layout padded by key padding (the cell mask is in each
    sequence's local coordinates) and packed again after; ``cu_seqlens`` is
    read on the host. With ``return_attn_probs`` returns ``(out, lse,
    None)``."""
    del convert_mask
    kpm = None
    if qkv.dim() == 5:
        q, k, v = qkv.unbind(dim=2)
    else:
        lengths = np.diff(np.asarray(torch.as_tensor(cu_seqlens).cpu()))
        b, s = len(lengths), int(max_s)
        dest = torch.from_numpy(np.concatenate(
            [i * s + np.arange(n) for i, n in enumerate(lengths)])).to(
                qkv.device)
        flat = qkv.new_zeros((b * s, *qkv.shape[1:])).index_copy(
            0, dest, qkv[: len(dest)])
        q, k, v = flat.reshape(b, s, *qkv.shape[1:]).unbind(dim=2)
        kpm = torch.arange(s)[None, :] < torch.from_numpy(lengths)[:, None]
    res = blocksparse_attention(
        q, k, v, blockmask, causal=causal, softmax_scale=softmax_scale,
        key_padding_mask=kpm, dropout_p=dropout_p, dropout_seed=dropout_seed,
        return_lse=return_attn_probs)
    out = res[0] if return_attn_probs else res
    if kpm is not None:
        out = out.reshape(-1, *out.shape[2:])[dest]
    return (out, res[1], None) if return_attn_probs else out


__all__ = [
    "BlockSparseLayout",
    "blocksparse_attention",
    "build_layout",
    "convert_blockmask",
    "expand_blockmask",
    "flash_blocksparse_attn_func",
]
