"""The recurrence steps a train step runs on the cells' plain scan (the
PyTorch loop of `ConvGRU` / `ConvLSTM` in the program, not a kernel),
steps per step: the program's `recurrence.plain_steps` counter summed over
each recorded `train.step` span and its descendants in the traced window.
The cascade's two cells give 2 T."""

from rgp_bench import span_tree, spans


def read(ctx):
    return span_tree.per_unit_count(spans.program_records(), "train.step",
                                    "recurrence.plain_steps")
