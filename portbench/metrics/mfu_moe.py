"""mfu_moe (mfu_moe.turns): the model FLOPs of a routed-expert model's
work in the profiled sub-window over (its length x 989 TFLOP/s), in %.

Model FLOPs per token: 2 x the active non-embedding parameters, per layer
the attention's projections (q and o: hidden x heads x head_dim each; k
and v: hidden x kv heads x head_dim each), the router (hidden x experts)
and k experts' SwiGLU (3 x hidden x moe_intermediate each), plus the
untied head (vocab x hidden); plus 4 x head_dim x heads x layers per
visible (query, key) pair. ``head_dim`` is the configuration's own.
Tokens as ``mfu.py`` counts them: the prompt tokens of every chunked
prefill call and the live rows of every decode call."""

import numpy as np

from portbench.harness.common import PEAK_FLOPS, spans_named


def active_params(c) -> int:
    e, d = c["hidden_size"], c["head_dim"]
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    attn = 2 * e * h * d + 2 * e * hkv * d
    router = e * c["num_experts"]
    experts = c["num_experts_per_tok"] * 3 * e * c["moe_intermediate_size"]
    return c["num_hidden_layers"] * (attn + router + experts) \
        + c["vocab_size"] * e


def serve_flops(ctx) -> float:
    c = ctx.config
    n = active_params(c)
    per_pair = 4 * c["head_dim"] * c["num_attention_heads"] \
        * c["num_hidden_layers"]
    tokens = pairs = 0
    for s in spans_named(ctx, "decode_step", profiled=True):
        live = [L for L in s[3]["lengths"] if L >= 0]
        tokens += len(live)
        pairs += sum(L + 1 for L in live)
    for s in spans_named(ctx, "chunk_prefill_step", profiled=True):
        for p, k in zip(s[3]["pos0"], s[3]["chunk_lens"]):
            if k > 0:
                tokens += k
                pairs += int((p + np.arange(k) + 1).sum())
    return 2 * n * tokens + per_pair * pairs


def read(ctx):
    if ctx.trace is None or ctx.kind != "serve" \
            or "num_experts" not in ctx.config:
        return None
    flops = serve_flops(ctx)
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_s * PEAK_FLOPS)
