"""ttft_p95_ms: the 95th percentile, over every request submitted inside
the window, of its first token's time less its submission. The closed
loop was opened in set-up, so none of them waits on its first lockstep
admission. A request that never got a first token counts with the time
the run waited for it."""

from portbench.harness.common import percentile


def read(ctx):
    if ctx.kind != "serve" or not ctx.served:
        return None
    return percentile([((s.first if s.first is not None else ctx.t_drained)
                        - s.submitted) * 1e3 for s in ctx.served], 95)
