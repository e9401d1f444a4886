"""The train loop's wait for its next batch, ms per batch (one a step):
the mean of the program's `input.wait` spans in the traced window (the
consumer's `q.get()` of the prefetch queue and its stream's wait for the
batch's copy)."""

from rgp_bench import spans


def read(ctx):
    return spans.mean_ms(spans.program_records(), "input.wait")
