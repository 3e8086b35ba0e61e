"""Plain Qwen3-MoE in float32, the benchmark's reference for the
``qwen3_moe`` family.

Written from the published model (Qwen3 technical report, 2025; the
layer equations of ``transformers``' ``modeling_qwen3_moe.py``): every
layer is attention then routed experts. Attention: RMSNorm, q/k/v
projections to heads of ``head_dim`` (which need not be hidden /
heads), a per-head RMSNorm of q and of k, half-split rotary, causal
grouped-query attention at scale ``head_dim`` ** -0.5, the output
projection. Experts: RMSNorm, router logits, softmax, the top
``num_experts_per_tok`` divided by their sum (``norm_topk_prob``), and the
weighted sum of the chosen experts' SwiGLU ``down(silu(gate(h)) *
up(h))``, computed expert by expert over the tokens that chose it
(boolean masks). Final RMSNorm, untied head. Plain torch operations only,
TF32 off, layer by layer (each layer's weights cast to float32 once, one
layer at a time, so that it fits beside the bf16 weights on one card)
and in blocks of 1,024 query rows. It imports nothing of the program and
takes only the benchmark's weights and inputs.

Departures from the published model: no multi-token prediction (the
published checkpoint has none), no router auxiliary loss (training
only), no weights beyond the config (they come from the seed), and the
router's logits in float32 (the program computes them in bf16, as
``transformers`` does).

``mode="fp8"`` is the lower-precision control: every product's operands,
the router's and the experts' included, are rounded to float8 e4m3 (rows
of activations and of weights each with their own scale), the rest as in
float32.
"""

from __future__ import annotations

import torch

from portbench.reference.llama import (  # noqa: F401  (no_tf32: the API)
    attention,
    linear,
    no_tf32,
    rms_norm,
    rope,
)

F = torch.nn.functional


def experts(h, w, p, c, mode):
    """The routed experts' output for tokens h (T, e), expert by
    expert."""
    E, k = c["num_experts"], c["num_experts_per_tok"]
    I = c["moe_intermediate_size"]
    probs = torch.softmax(linear(h, w(p + "mlp.router.weight"), mode), -1)
    wt, idx = torch.topk(probs, k, dim=-1)
    if c["norm_topk_prob"]:
        wt = wt / wt.sum(-1, keepdim=True)
    gate_up, down = w(p + "mlp.gate_up_proj"), w(p + "mlp.down_proj")
    out = torch.zeros_like(h)
    for e in range(E):
        rows, choice = torch.where(idx == e)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = linear(x, gate_up[e, :I], mode)
        u = linear(x, gate_up[e, I:], mode)
        y = linear(F.silu(g) * u, down[e], mode)
        out.index_add_(0, rows, y * wt[rows, choice, None])
    return out


def block(x, w, n, c, mode):
    """Decoder layer n on x (b, s, e) in float32; ``w(name)`` gives a
    float32 weight."""
    p = f"layers.{n}."
    b, s, e = x.shape
    H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    pos = torch.arange(s, device=x.device)
    h = rms_norm(x, w(p + "input_layernorm.weight"), eps)
    q = linear(h, w(p + "attn.q_proj.weight"), mode).view(b, s, H, hd)
    k = linear(h, w(p + "attn.k_proj.weight"), mode).view(b, s, Hkv, hd)
    v = linear(h, w(p + "attn.v_proj.weight"), mode).view(b, s, Hkv, hd)
    q = rope(rms_norm(q, w(p + "attn.q_norm.weight"), eps), pos, theta)
    k = rope(rms_norm(k, w(p + "attn.k_norm.weight"), eps), pos, theta)
    a = attention(q, k, v, None, mode)
    x = x + linear(a.reshape(b, s, H * hd), w(p + "attn.o_proj.weight"),
                   mode)
    h = rms_norm(x, w(p + "post_attention_layernorm.weight"), eps)
    return x + experts(h.reshape(-1, e), w, p, c, mode).view(b, s, e)


@torch.no_grad()
def served_logits(weights: dict, c: dict, seqs, mode="fp32"):
    """Teacher-forced logits. ``seqs``: [(ids (n,) int64, first)]; returns
    for each the float32 logits (n - first, vocab) of positions first ..
    n-1 (position t predicts token t + 1). Layer-major over all sequences:
    each layer's weights are cast to float32 once and dropped after it."""
    xs = [weights["wte.weight"][ids].float()[None] for ids, _ in seqs]
    for n in range(c["num_hidden_layers"]):
        cache = {}

        def w(name):
            if name not in cache:
                cache[name] = weights[name].float()
            return cache[name]

        xs = [block(x, w, n, c, mode) for x in xs]
        del cache
    norm = weights["norm.weight"].float()
    head = weights["lm_head.weight"].float()
    return [linear(rms_norm(x[0, first:], norm, c["rms_norm_eps"]), head,
                   mode) for x, (_, first) in zip(xs, seqs)]
