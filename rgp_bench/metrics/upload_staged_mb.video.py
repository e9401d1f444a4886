"""The bytes the served program stages through its pinned upload lanes per
request, MB (1e6 bytes): the program's `upload.staged_bytes` counter over
its recorded `serve.predict` spans in the traced window (0 for a request
uploaded directly; None for a program that counts no such bytes)."""

from rgp_bench import spans


def read(ctx):
    n = spans.mean_count(spans.program_records(), "serve.predict",
                         "upload.staged_bytes")
    return None if n is None else n / 1e6
