#!/usr/bin/env python3
"""Time kernel Q1 (`csrc/conv3d_int8.cu`) under other tile plans than the
wrapper's, layer by layer, on one NVIDIA card.

    python3 scripts/torch_q1_plans.py     # from the repo root

A plan is what `ops/kernels/conv3d_int8.tile_plan` hands the C entry
point: the box of 128 output positions and the Cout tile BN (the ring
depth follows from BN and the K step). Each tower layer at the served
160 clips (seeded random int8 activations and weights, the calibrated
scales' magnitudes) runs under the wrapper's plan and each alternative
below; an alternative must equal the wrapper's output bit for bit, then
all are timed with CUDA events in turns (wrapper's, alternatives,
alternatives reversed, wrapper's). The last line is a JSON object of the
times in ms.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, cuda_ms  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.ops.kernels import build  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.ops.kernels import (  # noqa: E402
    conv3d_int8 as q1)

CLIPS = 160
# (name, input D x H x W x Cin at 160 clips, Cout)
LAYERS = [("conv1a", (16, 112, 112, 3), 64), ("conv2a", (16, 56, 56, 64), 128),
          ("conv3a", (8, 28, 28, 128), 256), ("conv3b", (8, 28, 28, 256), 256),
          ("conv4a", (4, 14, 14, 256), 512), ("conv4b", (4, 14, 14, 512), 512),
          ("conv5a", (2, 7, 7, 512), 512)]
# alternatives to the wrapper's plan: (box, bn)
ALTERNATIVES = {
    "conv1a": [((2, 8, 8), 64), ((2, 4, 16), 64)],
    "conv2a": [((2, 8, 8), 128), ((4, 4, 8), 64)],
    "conv3a": [((2, 4, 16), 256), ((8, 4, 4), 128)],
    "conv3b": [((2, 4, 16), 256), ((8, 4, 4), 128)],
    "conv4a": [((4, 2, 16), 128), ((4, 4, 8), 256)],
    "conv4b": [((4, 2, 16), 128), ((4, 4, 8), 256)],
    "conv5a": [((2, 8, 8), 128), ((2, 8, 8), 64)],
}


def run(x, wq, wscale, b, plan, out):
    """One launch of the kernel under plan (box, bn), uncounted."""
    n, d, h, w, cin = x.shape
    box, bn = plan
    bk = 128 if cin % 128 == 0 else (64 if cin % 64 == 0 else wq.shape[1])
    stages = 2 if cin <= 4 else q1.ring_stages(bn, bk)
    build.launch("conv3d_int8", x.device, x.data_ptr(), wq.data_ptr(),
                 wscale.data_ptr(), b.data_ptr(), 0.0123, 0.05, 0,
                 out.data_ptr(), n, d, h, w, cin, wq.shape[0], wq.shape[1],
                 *box, bn, stages)


def label(plan) -> str:
    box, bn = plan
    return f"box {'x'.join(map(str, box))} BN {bn}"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    build.load()
    rng = np.random.RandomState(7)
    times = {}
    for name, (d, h, w, cin), cout in LAYERS:
        x = torch.from_numpy(rng.randint(-20, 21, (CLIPS, d, h, w, cin))
                             .astype(np.int8)).cuda()
        wq = torch.from_numpy(q1.pack_weights(rng.randint(
            -127, 128, (cout, cin, 3, 3, 3)).astype(np.int8))).cuda()
        wscale = torch.from_numpy((rng.rand(cout) * 1e-4 + 1e-5).astype(
            np.float32)).cuda()
        b = torch.from_numpy((rng.randn(cout) * 0.1).astype(
            np.float32)).cuda()
        plan = q1.tile_plan(tuple(x.shape), cout)
        plans = {"wrapper": (plan["box"], plan["bn"])}
        for alt in ALTERNATIVES[name]:
            plans[label(alt)] = alt
        outs = {}
        for name_, p in plans.items():
            outs[name_] = torch.empty((CLIPS, d, h, w, cout), dtype=torch.int8,
                                      device="cuda")
            run(x, wq, wscale, b, p, outs[name_])
        torch.cuda.synchronize()
        for name_, out in outs.items():
            if not torch.equal(out, outs["wrapper"]):
                print(f"{name} {name_}: differs from the wrapper's plan",
                      flush=True)
                return 1
        names = list(plans)
        ms = {name_: [] for name_ in names}
        for name_ in names + names[1:][::-1] + names[:1]:
            ms[name_].append(cuda_ms(lambda: run(x, wq, wscale, b,
                                                 plans[name_], outs[name_]), 5))
        gop = q1.conv_ops(tuple(x.shape), cout) / 1e9
        times[name] = {name_: float(np.mean(v)) for name_, v in ms.items()}
        print(f"{name} x {list(x.shape)} -> {cout} ({gop:.1f} GOP): " + ", ".join(
            f"{name_} ({label(plans[name_])}) {t:.4f} ms {gop / t:.1f} TOP/s"
            for name_, t in times[name].items()) + f" [{card}]", flush=True)
        del x, outs
        torch.cuda.empty_cache()
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
