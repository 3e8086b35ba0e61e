"""chunk_issue_ms: the host's time to issue one chunk of chunked prefill:
the mean length of the program's ``llama.chunk_prefill_step`` span
(``models/llama_decode.py``), which ends when the chunk's last launch is
queued, before the caller's synchronize; over the profiled sub-window.

Read under the profiler, which adds its own cost to every launch: about
twice the untraced issue time (see ``decode_issue_ms``), and not
comparable with ``chunk_prefill_ms``, which is timed over the whole window
without the profiler. Two traced longdoc runs on one seed read 67.5 and
83.9 ms on an H100."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "llama.chunk_prefill_step")
