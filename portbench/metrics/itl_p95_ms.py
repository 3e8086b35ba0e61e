"""itl_p95_ms: the 95th percentile over every gap between consecutive
output tokens of every request, of the gaps that lie inside the window
(requests in flight as it opened included)."""

from portbench.harness.common import percentile


def read(ctx):
    if ctx.kind != "serve":
        return None
    t0, t1 = ctx.window
    gaps = [(b - a) * 1e3 for s in ctx.in_flight + ctx.served
            for a, b in zip(s.times, s.times[1:]) if t0 <= a and b <= t1]
    return percentile(gaps, 95) if gaps else None
