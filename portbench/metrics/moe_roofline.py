"""moe_roofline (moe_roofline.turns): the routed experts' grouped GEMMs
in decode (``models/moe.py``: ``torch._grouped_mm``, two launches a layer)
as a share in % of their roofline bound over the device time of those
kernels in the profiled sub-window.

Per decode call, T is its live rows (length >= 0), each routed to k of E
experts: T k slots. Bytes per layer: the weights of the experts expected
to be hit under uniform routing, E (1 - (1 - k / E) ** T) x 3 x hidden x
moe_intermediate, plus each slot's rows read and written by both
products (hidden in, 2 x moe_intermediate out; moe_intermediate in,
hidden out). Products per layer: 2 x 3 x hidden x moe_intermediate per
slot. Bound = the larger of bytes over 3.35 TB/s and products over 989
TFLOP/s, per layer, summed over the layers and the calls, and scaled by
the share of the calls' grouped GEMM launches the trace holds.

The kernels are found by name (``KERNELS``: the names the grouped GEMM's
CUTLASS kernel and its data preparation carry on the H100, and ``moe``
for any the port writes); a launch belongs to decode when the attention
kernel before it is K5 (``paged_decode``), to a prefill chunk when it is
K6 (``paged_chunk``). Chunks are left out: a decode row is its own
sequence and the router spreads the rows as the uniform count says
(counted on an H100: 109.8 to 110.5 experts a layer at 31-32 rows,
against 110.7-111.8), but the tokens of one chunk come from one sequence
and, under the benchmark's random weights, route alike (19.5 experts a
layer on average for 512 tokens, against 128), so the uniform count
would overstate their bytes about threefold."""

from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS, spans_named

KERNELS = ("moe", "GroupProblemShape", "grouped")
LAUNCH = ("moe", "GroupProblemShape")  # one per product (not the preparation)
DECODE, CHUNK = "paged_decode", "paged_chunk"
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(tokens: int, c: dict) -> float:
    if tokens <= 0:
        return 0.0
    e, i = c["hidden_size"], c["moe_intermediate_size"]
    E, k = c["num_experts"], c["num_experts_per_tok"]
    elem = ELEM[c["torch_dtype"]]
    slots = tokens * k
    hit = E * (1.0 - (1.0 - k / E) ** tokens)
    n_bytes = (hit * 3 * e * i + slots * (e + 2 * i + i + e)) * elem
    flops = 2 * 3 * e * i * slots
    return c["num_hidden_layers"] * max(n_bytes / PEAK_BYTES,
                                        flops / PEAK_FLOPS)


def decode_tokens(ctx) -> list[int]:
    return [sum(1 for L in s[3]["lengths"] if L >= 0)
            for s in spans_named(ctx, "decode_step", profiled=True)]


def decode_kernels(trace) -> tuple[float, int]:
    """(device seconds, product launches) of the expert kernels that
    follow a K5 launch, in stream order."""
    total, launches, phase = 0.0, 0, None
    for name, _, dur in trace.device:
        if DECODE in name:
            phase = DECODE
        elif CHUNK in name:
            phase = CHUNK
        elif phase == DECODE and any(k in name for k in KERNELS):
            total += dur / 1e6
            launches += any(k in name for k in LAUNCH)
    return total, launches


def read(ctx):
    if ctx.trace is None or "num_experts" not in ctx.config:
        return None
    calls = decode_tokens(ctx)
    t, launches = decode_kernels(ctx.trace)
    if not calls or t <= 0:
        return None
    held = launches / (2 * ctx.config["num_hidden_layers"] * len(calls))
    b = held * sum(bound_s(T, ctx.config) for T in calls)
    return 100.0 * b / t
