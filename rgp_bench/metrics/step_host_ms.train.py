"""The host's time to issue one train step, ms: the mean of the program's
`train.step` spans in the traced window (flip, forward, backward and
optimizer as Python and the launches issue them; the device runs
behind)."""

from rgp_bench import spans


def read(ctx):
    return spans.mean_ms(spans.program_records(), "train.step")
