"""output_tokens_per_s: every output token that reached the host inside
the window, over the window's length (from its opening to the end of the
engine step that closed it), requests in flight as it opened
included."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    t0, t1 = ctx.window
    n = sum(1 for s in ctx.in_flight + ctx.served
            for t in s.times if t0 <= t <= t1)
    return n / (t1 - t0)
