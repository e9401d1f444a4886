"""The caller's host time in the served program's upload of its uint8
videos, ms per request: the program's `serve.upload` spans under its
recorded `serve.predict` spans in the traced window. A pageable copy
holds the host until the copy is done, and the copy waits behind the
work queued on its stream."""

from rgp_bench import spans


def read(ctx):
    return spans.per_unit_ms(spans.program_records(), "serve.predict",
                             "serve.upload")
