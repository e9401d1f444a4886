"""The bytes the prefetch worker copies to the device per batch (one a
step), MB (1e6 bytes): the program's `input.bytes` counter over its
`input.put` spans in the traced window, after the host's cast."""

from rgp_bench import spans


def read(ctx):
    n = spans.mean_count(spans.program_records(), "input.put",
                         "input.bytes")
    return None if n is None else n / 1e6
