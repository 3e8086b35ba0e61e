"""decode_step_ms: wall time of one ``llama_decode.decode_step`` call, each
ending in a synchronize (traced run), the mean over the window's calls."""

from portbench.harness.common import spans_named


def read(ctx):
    calls = spans_named(ctx, "decode_step")
    if not calls:
        return None
    return sum(b - a for _, a, b, _ in calls) / len(calls) * 1e3
