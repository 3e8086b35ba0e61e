"""k6_roofline: K6, the paged chunk kernel with its split merge
(``kernels/chunk.py`` -> ``csrc/paged_chunk.cu``), as a share in % of its
roofline bound over the device time of its kernels in the profiled
sub-window. In chunked prefill the chunk's K/V reach the cache by K7c
before K6 runs, so K6 reads them as cache rows.

Per chunk call and layer, a live row at position p with c new tokens:
query p + i sees keys max(0, p + i - W) .. p + i under a window W. Bytes:
the row's keys max(0, p - W) .. p + c - 1 as K and V read once, q read and
the output written once. Products: 4 d per visible (query, key) pair per
query head. Bound = the larger of bytes over 3.35 TB/s and products over
989 TFLOP/s, summed over the calls."""

import numpy as np

from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS, spans_named

KERNEL = "paged_chunk"
MERGE = "paged_merge"  # the split merge, after the K5 or K6 launch it serves
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def row_counts(p, c, window):
    """(keys read, visible pairs) of one row: c queries from position p."""
    pos = p + np.arange(c)
    lo = np.zeros_like(pos) if window is None else np.maximum(0, pos - window)
    pairs = int((pos - lo + 1).sum())
    first = 0 if window is None else max(0, p - window)
    return p + c - first, pairs


def bound_s(pos0, chunk_lens, c):
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    e = ELEM[c["torch_dtype"]]
    n_bytes = flops = 0
    for p, n in zip(pos0, chunk_lens):
        if n <= 0:
            continue
        keys, pairs = row_counts(p, n, c.get("sliding_window"))
        n_bytes += (2 * keys * hkv * d + 2 * n * h * d) * e
        flops += 4 * d * pairs * h
    layers = c["num_hidden_layers"]
    return layers * max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)


def device_s(trace, kernel):
    """Device seconds of ``kernel`` launches and of the merges that follow
    them on the stream."""
    total, owner = 0.0, None
    for name, _, dur in trace.device:
        if KERNEL in name or "paged_decode" in name:
            owner = KERNEL if KERNEL in name else "paged_decode"
        if kernel in name or (MERGE in name and owner == kernel):
            total += dur / 1e6
    return total


def read(ctx):
    if ctx.trace is None:
        return None
    calls = spans_named(ctx, "chunk_prefill_step", profiled=True)
    t = device_s(ctx.trace, KERNEL)
    if not calls or t <= 0:
        return None
    b = sum(bound_s(s[3]["pos0"], s[3]["chunk_lens"], ctx.config)
            for s in calls)
    return 100.0 * b / t
