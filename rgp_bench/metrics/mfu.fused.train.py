"""The raw-video train step's share of the chip's bf16 peak, %: the frozen
tower's forward over the step's B * F / 16 clips (`counts/c3d.py`) and the
gaze head's forward and backward over its B * T frames
(`counts/gaze.train_ops`), counted from shapes, times the steps of the
measured window over its seconds."""

from rgp_bench.counts import c3d, gaze, peaks


def read(ctx):
    s = ctx.shapes
    if not ctx.units or ctx.window_s <= 0 or "clips" not in s:
        return None
    ops = (c3d.ops(s["c3d_channels"], s["clips"], crop=s["crop"])
           + gaze.train_ops(s["model"], s["cell"],
                            s["batch"] * s["timesteps"]))
    return 100.0 * ops / peaks.OPS_PER_S["bfloat16"] * ctx.units \
        / ctx.window_s
