"""host_syncs_per_step: the engine's host-blocking transfers per
``ServingEngine.step()``: the count of its ``serve.to_device`` (a copy
from pageable host memory) and ``serve.readback`` (sampled tokens to the
host) spans over the count of its ``serve.step`` spans, in the profiled
sub-window (which opens and closes between steps)."""

from portbench.harness.program_spans import spans


def read(ctx):
    steps = spans(ctx, "serve.step")
    if not steps:
        return None
    return len(spans(ctx, "serve.to_device", "serve.readback")) / len(steps)
