"""k2_roofline: K2, the flash-attention backward (``kernels/flash_bwd.py``
-> ``csrc/flash_bwd.cu``: its row statistics, the band instance and the
dQ conversion), as a share in % of its roofline bound over its device time
in the profiled steps.

One launch per layer per training step on (b, s) tokens over the causal
band's visible pairs. Products: 10 d per visible pair per query head (QK^T
again, dO V^T, dV, dK, dQ). Bytes: q, k, v, o, dO and the fp32
log-sum-exp read once, dq, dk, dv written once. Bound = the larger of
bytes over 3.35 TB/s and products over 989 TFLOP/s."""

import numpy as np

from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS, spans_named

KERNELS = ("flash_bwd", "bwd_stats", "bwd_dq")
PRODUCTS_PER_PAIR = 10


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
    q_like, kv_like = b * s * h * d, b * s * hkv * d
    n_bytes = 2 * (4 * q_like + 4 * kv_like) + 4 * b * h * s
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
