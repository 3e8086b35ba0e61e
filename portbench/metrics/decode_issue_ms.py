"""decode_issue_ms: the host's time to issue one decode step: the mean
length of the program's ``llama.decode_step`` span
(``models/llama_decode.py``), which ends when the step's last launch is
queued, before the caller's synchronize; over the profiled sub-window.

Read under the profiler, which adds its own cost to every launch: about
twice the untraced issue time (a Mistral-7B decode step at batch 64 on an
H100: 33.9 ms untraced, 73.5 ms profiled), and not comparable with
``decode_step_ms``, which is timed over the whole window without the
profiler. Two traced longdoc runs on one seed read 63.0 and 85.2 ms (35%
apart)."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "llama.decode_step")
