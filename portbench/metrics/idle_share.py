"""idle_share: the share in % of the profiled sub-window in which no
kernel, copy or memset ran on the device (1 - the union of the device
intervals over the window's length)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
