"""Plain-torch reference attention: the fp32 oracle for every kernel test.

Port of ``flash_attn_tpu/reference.py`` (causal and non-causal, GQA by
repeated kv heads, top-left causal alignment when sq != sk). On the card,
where JAX is absent, it stands in for the JAX package. The repo's accuracy
rule holds a kernel to

    max|kernel - ref_fp32| <= 2 * max|ref_native - ref_fp32|

with ``ref_fp32 = attention_ref(..., upcast=True)`` and ``ref_native =
attention_ref(..., upcast=False)``. Inputs are (batch, heads, seq, d).
"""

from __future__ import annotations

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _expand_kv(q, k, v):
    group = q.shape[-3] // k.shape[-3]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=-3),
            v.repeat_interleave(group, dim=-3))


def attention_ref(q, k, v, *, causal: bool = False,
                  softmax_scale: float | None = None, upcast: bool = True):
    """Reference attention. ``upcast=True`` computes in fp32 (the ground
    truth); ``upcast=False`` computes in the input dtype (the baseline whose
    error sets the bar). Returns out in the q dtype."""
    orig_dtype = q.dtype
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    k, v = _expand_kv(q, k, v)
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    scores = (q @ k.transpose(-1, -2)).float() * softmax_scale
    if causal:  # top-left: every row sees key 0, so no row is empty
        visible = torch.ones(scores.shape[-2:], dtype=torch.bool,
                             device=q.device).tril()
        scores = torch.where(visible, scores, DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if not upcast:
        probs = probs.to(orig_dtype)
    return (probs @ v).to(orig_dtype)


def attention_lse_ref(q, k, v, *, causal: bool = False,
                      softmax_scale: float | None = None):
    """fp32 logsumexp of the scaled scores, (..., sq)."""
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    k, _ = _expand_kv(q, k, v)
    scores = (q.float() @ k.float().transpose(-1, -2)) * softmax_scale
    if causal:
        visible = torch.ones(scores.shape[-2:], dtype=torch.bool,
                             device=q.device).tril()
        scores = scores.masked_fill(~visible, float("-inf"))
    return torch.logsumexp(scores, dim=-1)
