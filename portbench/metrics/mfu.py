"""mfu (mfu.longdoc, mfu.train): the model FLOPs of the work in
the profiled sub-window over (its length x 989 TFLOP/s), in %.

Model FLOPs count what the model needs, not what the program runs: per
token 2 N in serving and 6 N in training, N the non-embedding parameters
(the untied head included), plus per visible (query, key) pair per query
head per layer 4 d in serving and 14 d in training (forward 4, backward
10). Serving counts the prompt tokens of every chunked prefill call and
the live rows of every decode call; training counts every step."""

import numpy as np

from portbench.harness.common import PEAK_FLOPS, spans_named


def non_embedding_params(c):
    e, i, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = e // c["num_attention_heads"]
    attn = 2 * e * c["num_attention_heads"] * hd \
        + 2 * e * c["num_key_value_heads"] * hd
    layer = attn + 3 * e * i + 2 * e
    return c["num_hidden_layers"] * layer + e + v * e


def visible(pos, window):
    pos = np.asarray(pos)
    lo = np.zeros_like(pos) if window is None else np.maximum(0, pos - window)
    return int((pos - lo + 1).sum())


def serve_flops(ctx):
    c = ctx.config
    n, w = non_embedding_params(c), c.get("sliding_window")
    per_pair = 4 * (c["hidden_size"] // c["num_attention_heads"]) \
        * c["num_attention_heads"] * c["num_hidden_layers"]
    tokens = pairs = 0
    for s in spans_named(ctx, "decode_step", profiled=True):
        live = [L for L in s[3]["lengths"] if L >= 0]
        tokens += len(live)
        pairs += visible(live, w) if live else 0
    for s in spans_named(ctx, "chunk_prefill_step", profiled=True):
        for p, k in zip(s[3]["pos0"], s[3]["chunk_lens"]):
            if k > 0:
                tokens += k
                pairs += visible(p + np.arange(k), w)
    return 2 * n * tokens + per_pair * pairs


def train_flops(ctx):
    c, t = ctx.config, ctx.traffic
    steps = spans_named(ctx, "train.step", profiled=True)
    d = c["hidden_size"] // c["num_attention_heads"]
    pairs = visible(np.arange(t["seq"]), c.get("sliding_window")) \
        * t["batch"]
    per_step = 6 * non_embedding_params(c) * t["batch"] * t["seq"] \
        + 14 * d * pairs * c["num_attention_heads"] * c["num_hidden_layers"]
    return len(steps) * per_step


def read(ctx):
    if ctx.trace is None:
        return None
    flops = serve_flops(ctx) if ctx.kind == "serve" else train_flops(ctx)
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_s * PEAK_FLOPS)
