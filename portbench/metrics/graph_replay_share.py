"""graph_replay_share: the share in % of the Llama serving calls in the
profiled sub-window (the program's ``llama.chunk_prefill_step`` and
``llama.decode_step`` spans, ``models/llama_decode.py``) that replayed a
CUDA graph: those holding a ``llama.graph_replay`` span. A call that
captured its graph, or ran its launches one by one, holds none. A program
without the replay span reads nothing."""

from portbench.harness.program_spans import spans

PHASES = ("llama.chunk_prefill_step", "llama.decode_step")


def read(ctx):
    calls = spans(ctx, *PHASES)
    replays = spans(ctx, "llama.graph_replay")
    if not calls or not replays:
        return None
    inside = sum(1 for _, a, d in calls
                 if any(a <= t and t + r <= a + d for _, t, r in replays))
    return 100.0 * inside / len(calls)
