"""The ConvGRU recurrence's share of its roofline in a train step, %: the
least time of its forward and backward without recomputation (three
passes of the state convs at the bf16 peak, or its bytes at the memory
rate) over the device time per step of the kernels that run it in the
traced window (B1, and G, B2 and W of the backward)."""

from rgp_bench.counts import gaze, peaks
from rgp_bench.profile import kernel_seconds

KERNELS = ("convgru_fwd_kernel", "convgru_bwd_kernel", "gates_wgmma",
           "gates_f32", "wgrad_wgmma", "wgrad_f32", "wgrad_reduce")


def read(ctx):
    s = ctx.shapes
    if ctx.trace is None or s.get("cell") != "convgru" or \
            not ctx.trace_units:
        return None
    per_step = kernel_seconds(ctx.trace, KERNELS) / ctx.trace_units
    if per_step <= 0:
        return None
    least = gaze.recurrence_train_least_s(
        s["timesteps"], s["batch"], s["model"]["rnn_state_size"],
        peaks.OPS_PER_S["bfloat16"], peaks.BYTES_PER_S)
    return 100.0 * least / per_step
