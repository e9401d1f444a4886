"""The host's time to issue a train step's optimizer, ms per step: the
program's `train.optimizer` spans (the global norm and the per-leaf Adam
update) under its recorded `train.step` spans in the traced window."""

from rgp_bench import spans


def read(ctx):
    return spans.per_unit_ms(spans.program_records(), "train.step",
                             "train.optimizer")
