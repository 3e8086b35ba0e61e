"""chunk_prefill_ms: wall time of one ``chunk_prefill_step`` call (one
prefill chunk of every admitted row), each ending in a synchronize (traced
run), the mean over the window's calls."""

from portbench.harness.common import spans_named


def read(ctx):
    calls = spans_named(ctx, "chunk_prefill_step")
    if not calls:
        return None
    return sum(b - a for _, a, b, _ in calls) / len(calls) * 1e3
