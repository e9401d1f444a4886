"""The device's idle share of the traced window, %: the time in which no
kernel ran (copies count as idle), over the window."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["kernel_busy_s"] / ctx.trace["window_s"])
