"""The cascade's train step's share of the chip's bf16 peak, %: the
forward and backward contractions a step needs (`counts/cascade.py`:
projection, both cells, the upsample and the fc head; the projection's
input gradient and the rematerialized steps not counted), counted from
shapes, times the steps of the measured window over its seconds."""

from rgp_bench.counts import cascade, peaks


def read(ctx):
    s = ctx.shapes
    if not ctx.units or ctx.window_s <= 0 or s.get("cell") != "cascade":
        return None
    seconds = cascade.train_ops(s["model"], s["cascade"],
                                s["batch"] * s["timesteps"]) \
        / peaks.OPS_PER_S["bfloat16"]
    return 100.0 * seconds * ctx.units / ctx.window_s
