"""The host's time in the program's `gaze.recurrence` spans, ms per train step:
the spans at any depth under its recorded `train.step` spans in the
traced window (the cascade's bottom ConvGRU at 7x7, under
`train.forward`), per step."""

from rgp_bench import span_tree, spans


def read(ctx):
    return span_tree.per_unit_ms(spans.program_records(), "train.step",
                                 "gaze.recurrence")
