"""The served program's share of the chip's peak, %: the contractions a
request needs (the tower's convs at the peak of the precision it runs in,
int8 or bf16; the gaze head's projection, cell convs and decoder at the
bf16 peak), counted from shapes, times the requests of the measured window
over its seconds."""

from rgp_bench.counts import c3d, gaze, peaks


def read(ctx):
    s = ctx.shapes
    if not ctx.units or ctx.window_s <= 0:
        return None
    tower = "int8" if s["program"] == "fused_int8" else "bfloat16"
    clips = s["batch"] * (s["frames"] // 16)
    seconds = (c3d.ops(s["c3d_channels"], clips, crop=s["crop"])
               / peaks.OPS_PER_S[tower]
               + gaze.forward_ops(s["model"], s["cell"],
                                  s["batch"] * s["timesteps"])
               / peaks.OPS_PER_S["bfloat16"])
    return 100.0 * seconds * ctx.units / ctx.window_s
