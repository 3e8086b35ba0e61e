"""prefill_pad_share: of the rows x width token slots of every chunked
prefill call in the window, the share in % that carry no prompt token
(rows padded to a power of two, rows whose prompt ended in an earlier
chunk, and each row's last partial chunk). Read from each call's own
arguments: the ids' shape and the chunk lengths."""

from portbench.harness.common import spans_named


def read(ctx):
    calls = spans_named(ctx, "chunk_prefill_step")
    if not calls:
        return None
    slots = sum(s[3]["rows"] * s[3]["width"] for s in calls)
    used = sum(sum(s[3]["chunk_lens"]) for s in calls)
    return 100.0 * (slots - used) / slots
