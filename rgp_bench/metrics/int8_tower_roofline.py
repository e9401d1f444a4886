"""The int8 tower's share of its roofline, %: the least time of the
tower's work at the cell's shapes (its int8 operations at the int8 peak,
or its bytes at the memory rate) over the device time per request of the
kernels that run it in the traced window (Q1 and Q1-pool). The bound is
the tower's, not one kernel's, so it reads the same however the tower is
split into kernels."""

from rgp_bench.counts import c3d, peaks
from rgp_bench.profile import kernel_seconds

KERNELS = ("conv3d_int8", "maxpool3d_int8")


def read(ctx):
    s = ctx.shapes
    if ctx.trace is None or s.get("program") != "fused_int8" or \
            not ctx.trace_units:
        return None
    per_request = kernel_seconds(ctx.trace, KERNELS) / ctx.trace_units
    if per_request <= 0:
        return None
    clips = s["batch"] * (s["frames"] // 16)
    least = peaks.least_seconds(
        c3d.ops(s["c3d_channels"], clips, crop=s["crop"]),
        c3d.int8_bytes(s["c3d_channels"], clips, crop=s["crop"]), "int8")
    return 100.0 * least / per_request
