"""Routed SwiGLU experts (the sparse block of Qwen3-MoE), for
``LlamaBlock`` when ``cfg.num_experts`` is set. It replaces no kernel of
the JAX package, which has no experts.

Per token ``h`` (``n_embd``): router logits ``h @ router.T`` in
``cfg.dtype``, softmax in fp32, the top ``num_experts_per_tok`` kept and,
with ``norm_topk_prob``, divided by their sum; the output is the weighted
sum of the chosen experts' ``down(silu(gate(h)) * up(h))``
(``transformers``' ``Qwen3MoeSparseMoeBlock``). The experts are stacked:
``gate_up_proj`` (E, 2 I, n_embd) holds each expert's gate rows then its
up rows, ``down_proj`` (E, n_embd, I).

Dispatch without the host. Every (token, choice) pair is a slot; the
slots are sorted by expert (a stable sort, so the order is fixed), each
expert's rows end at ``ends[e]`` (a ``searchsorted`` over the sorted
ids), the tokens' rows are gathered in that order, both expert products
are grouped GEMMs over the groups ``ends`` marks, and each slot's output
goes back to its (token, choice) place before the weighted sum over the
choices (weights in ``cfg.dtype``, as ``transformers`` casts them; the sum
accumulates in fp32). No count is read on the host and every shape follows
the input's alone, so a call runs inside a CUDA graph
(``llama_decode``). Slots of tokens that are not ``live`` (padding rows
of a chunk, free decode slots) take the id E, sort past every expert,
are left out of the products, and return zeros.

On the card the grouped GEMMs are ``torch._grouped_mm`` (bf16, sm90,
group ends on the device; chosen by an A/B against a Triton grouped GEMM,
PERF.md); rows past the last group end are left unwritten there and are
masked before the sum. On the CPU each group is a plain product with its
bounds read on the host (the twin the CPU tests run). Bound on the H100:
the bytes of the experts hit in decode (~2 slots an expert at 32 rows),
the products in a prefill chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.llama_chain import swiglu, swiglu_plain


def route(logits, k: int, norm_topk_prob: bool):
    """(weights (T, k) fp32, experts (T, k) int64) of router logits (T,
    E): softmax in fp32, top k, renormalised with ``norm_topk_prob``."""
    p = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(p, k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    return w, idx


def dispatch(idx, live, num_experts: int):
    """The slots' order and the groups' ends: (order (T k,) the slots
    sorted by expert, ends (E,) int32, each expert's end row in that
    order). Slots of tokens not ``live`` take the id E, past every
    group."""
    if live is not None:
        idx = idx.masked_fill(~live[:, None], num_experts)
    sorted_ids, order = torch.sort(idx.flatten(), stable=True)
    ends = torch.searchsorted(
        sorted_ids, torch.arange(num_experts, device=idx.device,
                                 dtype=sorted_ids.dtype), right=True)
    return order, ends.to(torch.int32)


def grouped_mm(x, w, ends):
    """Rows ``ends[e-1]:ends[e]`` of x (S, K) times ``w[e].T`` (w (E, N,
    K)) for every expert e -> (S, N); rows past ``ends[-1]`` are not
    computed (zeros on the CPU, unwritten on the card)."""
    if x.is_cuda:
        grouped_mm.launches += 1
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)
    return grouped_mm_plain(x, w, ends)


def grouped_mm_plain(x, w, ends):
    """``grouped_mm``'s twin: one product per group, its bounds read on
    the host; rows past ``ends[-1]`` are zeros."""
    out = x.new_zeros(x.shape[0], w.shape[1])
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].t()
        start = end
    return out


_build.counter(grouped_mm)


def moe_experts(h, router_w, gate_up, down, k: int, norm_topk_prob: bool,
                live=None, glu=swiglu_plain):
    """The routed experts' output (T, n_embd) for tokens h (T, n_embd), in
    h's dtype; ``live`` (T,) bool or None (every token). ``glu(gate, up)``
    is each slot's SwiGLU on the two strided halves of the fused product:
    ``swiglu_plain``, or serving's one-launch ``swiglu``."""
    T, e = h.shape
    E, I = gate_up.shape[0], gate_up.shape[1] // 2
    w, idx = route(F.linear(h, router_w), k, norm_topk_prob)
    order, ends = dispatch(idx, live, E)
    xs = h[order // k]  # (T k, e): each slot's token row, by expert
    gu = grouped_mm(xs, gate_up, ends)
    a = glu(gu[:, :I], gu[:, I:])
    ys = grouped_mm(a, down, ends)
    y = torch.empty_like(ys).index_copy_(0, order, ys).view(T, k, e)
    out = torch.bmm(w.to(h.dtype)[:, None], y)[:, 0]
    if live is not None:
        out = torch.where(live[:, None], out, 0)
    return out


class MoeMlp(nn.Module):
    """``LlamaBlock``'s MLP with routed experts: ``router`` (E, n_embd),
    ``gate_up_proj`` (E, 2 I, n_embd), ``down_proj`` (E, n_embd, I), stored
    in ``cfg.param_dtype`` and computed in ``cfg.dtype``."""

    def __init__(self, cfg, **factory):
        super().__init__()
        self.config = cfg
        E, I, e = cfg.num_experts, cfg.moe_intermediate_size, cfg.n_embd
        self.router = nn.Linear(e, E, bias=False, **factory)
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * I, e, **factory))
        self.down_proj = nn.Parameter(torch.empty(E, e, I, **factory))

    def forward(self, x, live=None):
        """x (..., n_embd); ``live`` (...) bool or None."""
        cfg, dt = self.config, self.config.dtype
        h = x.reshape(-1, x.shape[-1]).to(dt)
        out = moe_experts(
            h, self.router.weight.to(dt), self.gate_up_proj.to(dt),
            self.down_proj.to(dt), cfg.num_experts_per_tok,
            cfg.norm_topk_prob, None if live is None else live.reshape(-1))
        return out.view(x.shape)

    def serve(self, x, live=None):
        """Serving: ``forward`` with each slot's SwiGLU in one launch."""
        cfg, dt = self.config, self.config.dtype
        h = x.reshape(-1, x.shape[-1]).to(dt)
        out = moe_experts(
            h, self.router.weight.to(dt), self.gate_up_proj.to(dt),
            self.down_proj.to(dt), cfg.num_experts_per_tok,
            cfg.norm_topk_prob, None if live is None else live.reshape(-1),
            glu=swiglu)
        return out.view(x.shape)
