"""engine_host_ms: per ``ServingEngine.step()`` in the window, its host
wall time less the wall time inside the model's phases it called (which
end in a synchronize in the traced run); the mean over steps, in ms.
Layer: ``serving/engine.py``'s scheduler (admission, page tables,
sampling)."""

from portbench.harness.common import spans_named

MODEL_CALLS = ("decode_step", "chunk_prefill_step")


def read(ctx):
    if ctx.kind != "serve":
        return None
    steps = spans_named(ctx, "engine.step")
    calls = [s for s in ctx.spans if s[0] in MODEL_CALLS]
    if not steps:
        return None
    total = 0.0
    for _, a, b, _ in steps:
        inside = sum(d - c for _, c, d, _ in calls if a <= c and d <= b)
        total += (b - a) - inside
    return total / len(steps) * 1e3
