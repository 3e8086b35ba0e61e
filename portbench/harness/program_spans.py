"""The program's own spans, as a traced run sees them.

The port marks its serving layers with spans (``flash_attn_tpu_torch
.tracing``: ``serve.step``, ``serve.chunk``, ``serve.to_device``,
``serve.readback``, ``llama.chunk_prefill_step``, ``llama.decode_step`` and
the Llama phases inside them). While a profiler runs, each span is also a
profiler range of its name, so the profiled sub-window's trace holds them
among its host annotations: (name, start us, length us). A program without
spans leaves none there, and the readers then find nothing to read.
"""

from __future__ import annotations


def spans(ctx, *names) -> list:
    """The profiled sub-window's host spans called one of ``names`` (the
    program's, or the harness's own), in the order they started."""
    tr = getattr(ctx, "trace", None)
    if ctx.kind != "serve" or tr is None:
        return []
    return sorted((h for h in tr.host if h[0] in names), key=lambda h: h[1])


def mean_ms(ctx, name: str):
    """The mean length of the spans called ``name``, in ms; None without
    one."""
    xs = spans(ctx, name)
    if not xs:
        return None
    return sum(d for _, _, d in xs) / len(xs) / 1e3
