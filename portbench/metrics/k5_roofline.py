"""k5_roofline: K5, the paged decode kernel with its append and its split
merge (``kernels/decode.py`` -> ``csrc/paged_decode.cu``), as a share in %
of its roofline bound over the device time of its kernels in the profiled
sub-window.

Per decode call and layer, each live row (length L before the append, the
new key at position L) sees keys max(0, L - W) .. L under a window W.
Bytes: those keys' K and V rows read once, q read and the output written
once, the new K and V rows written once. Products: 4 d per visible key per
query head. Bound = the larger of bytes over 3.35 TB/s and products over
989 TFLOP/s, summed over the calls."""

from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS, spans_named

KERNEL = "paged_decode"
MERGE = "paged_merge"  # the split merge, after the K5 or K6 launch it serves
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def visible_keys(length, window):
    lo = 0 if window is None else max(0, length - window)
    return length - lo + 1


def bound_s(lengths, c):
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    e = ELEM[c["torch_dtype"]]
    w = c.get("sliding_window")
    n_bytes = flops = 0
    for L in lengths:
        if L < 0:
            continue
        keys = visible_keys(L, w)
        n_bytes += (2 * keys * hkv * d + 2 * h * d + 2 * hkv * d) * e
        flops += 4 * d * keys * h
    layers = c["num_hidden_layers"]
    return layers * max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)


def device_s(trace, kernel):
    """Device seconds of ``kernel`` launches and of the merges that follow
    them on the stream."""
    total, owner = 0.0, None
    for name, _, dur in trace.device:
        if KERNEL in name or "paged_chunk" in name:
            owner = KERNEL if KERNEL in name else "paged_chunk"
        if kernel in name or (MERGE in name and owner == kernel):
            total += dur / 1e6
    return total


def read(ctx):
    if ctx.trace is None:
        return None
    calls = spans_named(ctx, "decode_step", profiled=True)
    t = device_s(ctx.trace, KERNEL)
    if not calls or t <= 0:
        return None
    b = sum(bound_s(s[3]["lengths"], ctx.config) for s in calls)
    return 100.0 * b / t
