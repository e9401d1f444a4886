"""The train loop's wait for its next batch from the prefetch iterator,
mean ms per step over the measured window (the benchmark's own span around
`next()`)."""


def read(ctx):
    if not ctx.units:
        return None
    return ctx.spans["input_wait_s"] / ctx.units * 1e3
