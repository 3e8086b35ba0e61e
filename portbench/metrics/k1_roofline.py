"""k1_roofline: K1, the flash-attention forward (``kernels/flash_fwd.py``
-> ``csrc/flash_fwd.cu``, its band instance under a window), as a share in
% of its roofline bound over its device time in the profiled steps.

One launch per layer per training step on (b, s) tokens: visible pairs
per sequence are the causal band's (row i sees keys max(0, i - W) .. i).
Products: 4 d per visible pair per query head. Bytes: q, k, v read and
the output and the fp32 log-sum-exp written once. Bound = the larger of
bytes over 3.35 TB/s and products over 989 TFLOP/s."""

import numpy as np

from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS, spans_named

KERNELS = ("flash_fwd",)
PRODUCTS_PER_PAIR = 4  # QK^T and PV, 2 each, per head dimension


def band_pairs(s, window):
    i = np.arange(s)
    lo = np.zeros_like(i) if window is None else np.maximum(0, i - window)
    return int((i - lo + 1).sum())


def launch_bound_s(c, t):
    b, s = t["batch"], t["seq"]
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    flops = PRODUCTS_PER_PAIR * d * band_pairs(s, c.get("sliding_window")) \
        * h * b
    n_bytes = 2 * (2 * b * s * h * d + 2 * b * s * hkv * d) + 4 * b * h * s
    return max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    steps = spans_named(ctx, "train.step", profiled=True)
    t = sum(d for n, _, d in ctx.trace.device
            if any(k in n for k in KERNELS)) / 1e6
    if not steps or t <= 0:
        return None
    bound = len(steps) * ctx.config["num_hidden_layers"] * launch_bound_s(
        ctx.config, ctx.traffic)
    return 100.0 * bound / t
