"""Device time of the host-to-device copies per request in the traced
window, ms: the served program's upload of the uint8 videos."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_units:
        return None
    seconds = ctx.trace["copy_s"]["HtoD"]
    return seconds / ctx.trace_units * 1e3 if seconds > 0 else None
