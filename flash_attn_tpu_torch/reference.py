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


def build_mask(sq: int, sk: int, *, causal: bool = False, q_positions=None,
               kv_positions=None, q_segment_ids=None, kv_segment_ids=None,
               window_left=None, window_right=None, num_sinks: int = 0,
               device=None):
    """Boolean (..., sq, sk) mask, True = attend (``flash_attn_tpu/
    reference.py:25`` ``build_mask``): causal by positions (default
    arange), the band i - window_left <= j <= i + window_right (None =
    unbounded), ORed with the first ``num_sinks`` key columns when there is
    a band, and equal non-negative segment ids."""
    if q_positions is None:
        q_positions = torch.arange(sq, device=device)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=device)
    qp, kp = q_positions[..., :, None], kv_positions[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask = mask & (qp >= kp)
    band = torch.ones_like(mask)
    if window_left is not None:
        band = band & (kp >= qp - window_left)
    if window_right is not None:
        band = band & (kp <= qp + window_right)
    if num_sinks and (window_left is not None or window_right is not None):
        band = band | (kp < num_sinks)
    mask = mask & band
    if q_segment_ids is not None:
        qs, ks = q_segment_ids[..., :, None], kv_segment_ids[..., None, :]
        mask = mask & (qs == ks) & (qs >= 0) & (ks >= 0)
    return mask


def alibi_bias(slopes, sq: int, sk: int, *, causal: bool, q_positions=None,
               kv_positions=None):
    """The ALiBi bias on the scaled scores, (b, h, sq, sk) or (1, h, sq,
    sk): slope * (j - i) under causal masking, -slope * |i - j| otherwise
    (positions default to arange; flash_fwd.py:254-284 there). ``slopes``
    (h,) or (b, h) fp32, not divided by the scale."""
    slopes = torch.as_tensor(slopes, dtype=torch.float32)
    if slopes.dim() == 1:
        slopes = slopes[None]
    dev = slopes.device
    qp = (torch.arange(sq, device=dev) if q_positions is None
          else q_positions)[..., :, None]
    kp = (torch.arange(sk, device=dev) if kv_positions is None
          else kv_positions)[..., None, :]
    dist = (kp - qp) if causal else -(qp - kp).abs()
    if dist.dim() == 3:  # per-row positions: (b, sq, sk)
        dist = dist[:, None]
    return slopes[:, :, None, None] * dist.float()


def attention_ref(q, k, v, *, causal: bool = False,
                  softmax_scale: float | None = None, mask=None,
                  upcast: bool = True, dropout_mask=None,
                  dropout_p: float = 0.0, return_attn_probs: bool = False,
                  bias=None, softcap: float | None = None):
    """Reference attention. ``upcast=True`` computes in fp32 (the ground
    truth); ``upcast=False`` computes in the input dtype (the baseline whose
    error sets the bar). Returns out in the q dtype.

    ``mask``: optional boolean (..., sq, sk), True = attend, ANDed with the
    causal mask. Rows with no visible key get probability 0, so their output
    is 0 (the kernels' ``l == 0`` rule; reference.py:122-134 there).
    ``softcap``: ``softcap * tanh(s / softcap)`` on the scaled scores, then
    the additive ``bias`` (e.g. ``alibi_bias``), then the masks
    (reference.py:71-146 there).
    ``dropout_mask``: optional boolean (..., sq, sk), True = keep, applied to
    the normalized probabilities and rescaled by 1 / (1 - dropout_p)
    (dropout after the softmax). ``return_attn_probs`` also returns the
    pre-dropout probabilities. Differentiable, so autograd through it is the
    oracle for the backward kernel's gradients."""
    orig_dtype = q.dtype
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    k, v = _expand_kv(q, k, v)
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    scores = (q @ k.transpose(-1, -2)).float() * softmax_scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if bias is not None:
        scores = scores + bias.float()
    visible = None
    if causal:  # top-left: every row sees key 0
        visible = torch.ones(scores.shape[-2:], dtype=torch.bool,
                             device=q.device).tril()
    if mask is not None:
        visible = mask if visible is None else mask & visible
    if visible is not None:
        scores = torch.where(visible, scores, DEFAULT_MASK_VALUE)
    probs_pre_drop = probs = torch.softmax(scores, dim=-1)
    if mask is not None:  # rows that see nothing: 0, not uniform
        probs_pre_drop = probs = torch.where(
            visible.any(dim=-1, keepdim=True), probs, 0.0)
    if dropout_mask is not None and dropout_p > 0.0:
        probs = torch.where(dropout_mask, probs, 0.0) / (1.0 - dropout_p)
    if not upcast:
        probs = probs.to(orig_dtype)
    out = (probs @ v).to(orig_dtype)
    return (out, probs_pre_drop) if return_attn_probs else out


def paged_chunk_ref(q, k_pages, v_pages, lengths, page_table, chunk_lens, *,
                    softmax_scale: float | None = None, upcast: bool = True,
                    window_left=None, num_sinks: int = 0, alibi_slopes=None,
                    softcap: float | None = None):
    """Dense oracle of paged chunk attention (and, at sq = 1 with chunk_lens
    = 1, of paged decode). q (b, sq, hq, d); each sequence's keys are
    gathered from its pages and row t sees keys [0, lengths - chunk_lens +
    t] (tail-aligned), with a window only those at or after its position -
    ``window_left`` and the first ``num_sinks``. The softcap goes on the
    scaled scores, then ALiBi (``alibi_slopes`` (hq,), slope * (kpos -
    qpos)). Padding rows (t >= chunk_lens) and rows that see no key give 0.
    ``upcast`` as in ``attention_ref``."""
    b, sq, _, d = q.shape
    ps = k_pages.shape[2]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    out = torch.zeros_like(q)
    for i in range(b):
        n, c = int(lengths[i]), int(chunk_lens[i])
        cached = min(n, page_table.shape[1] * ps)
        if cached <= 0 or c <= 0:
            continue
        pages = page_table[i, : -(-cached // ps)].long()
        qi = q[i].transpose(0, 1)  # (hq, sq, d)
        k, v = _expand_kv(qi, k_pages[:, pages].flatten(1, 2)[:, :cached],
                          v_pages[:, pages].flatten(1, 2)[:, :cached])
        if upcast:
            qi, k, v = qi.float(), k.float(), v.float()
        s = (qi @ k.transpose(-1, -2)).float() * softmax_scale
        t = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(cached, device=q.device)[None]
        qpos = n - c + t
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if alibi_slopes is not None:
            slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                     device=q.device)
            s = s + slopes[:, None, None] * (j - qpos).float()
        visible = (j <= qpos) & (t < c)
        if window_left is not None:
            visible = visible & ((j >= qpos - window_left) | (j < num_sinks))
        s = s.masked_fill(~visible, float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # empty rows: 0
        if not upcast:
            p = p.to(q.dtype)
        out[i] = (p @ v).to(q.dtype).transpose(0, 1)
    return out


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
