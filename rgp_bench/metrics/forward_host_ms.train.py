"""The host's time to issue a train step's forward, ms per step: the
program's `train.forward` spans (`model.loss`: projection, recurrence,
decoder, loss) under its recorded `train.step` spans in the traced
window."""

from rgp_bench import spans


def read(ctx):
    return spans.per_unit_ms(spans.program_records(), "train.step",
                             "train.forward")
