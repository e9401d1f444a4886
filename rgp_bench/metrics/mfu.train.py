"""The train step's share of the chip's bf16 peak, %: the forward and
backward contractions a step needs (projection, cell convs, decoder;
recomputation not counted), counted from shapes, times the steps of the
measured window over its seconds."""

from rgp_bench.counts import gaze, peaks


def read(ctx):
    s = ctx.shapes
    if not ctx.units or ctx.window_s <= 0:
        return None
    seconds = gaze.train_ops(s["model"], s["cell"],
                             s["batch"] * s["timesteps"]) \
        / peaks.OPS_PER_S["bfloat16"]
    return 100.0 * seconds * ctx.units / ctx.window_s
