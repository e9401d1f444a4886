"""Pretrain ShallowNet and save its params for grafting into the gaze
models: the port's counterpart of the JAX package's
`cli/pretrain_shallownet.py` (reference `saliency_shallownet.py
self_test`, `models/saliency_shallownet.py:415-503`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.pretrain_shallownet \\
        --dataset synthetic --max_steps 1000 --out /tmp/shallownet.pt
    python -m recurrent_gaze_prediction_tpu_torch.cli.train_gaze \\
        --model gaze_rnn --shallownet_pretrain /tmp/shallownet.pt ...

`--dataset salicon` trains on the SALICON train split under
`--salicon_root` (`data/salicon.py`: `images/train98x98/`,
`saliencymaps/train49x49/`, `fixations/train/`; 80% of it, the rest held
out as the JAX package does). `--dataset synthetic` trains on an
image-level stand-in with the SALICON batch API (frames and gaze maps of
the synthetic clip corpus). `--out` must not exist yet (checked before
training). `--train_dir` also writes the losses
to `metrics.jsonl` every `--steps_per_logprint` steps.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

from ..config import OptimizerConfig
from ..data import salicon as salicon_data
from ..data import synthetic
from ..train.checkpoint import save_params
from ..train.saliency import fit_shallownet
from ..train.writer import MetricWriter
from ..utils import log, resolve_device


class SyntheticSaliency:
    """Image-level synthetic stand-in with the SALICON batch API: the
    frames and gaze maps of `max(n // 8, 2)` synthetic clips of 8 frames,
    the first n of them."""

    def __init__(self, n: int = 256, seed: int = 0):
        clips = synthetic.make_clip_windows(max(n // 8, 2), 8, seed=seed)
        self.images = clips.frames.reshape(-1, 98, 98, 3)[:n]
        self.maps = clips.gazemaps.reshape(-1, 49, 49)[:n]
        self._i = 0

    def __len__(self) -> int:
        return len(self.images)

    def next_batch(self, batch_size: int):
        if self._i + batch_size > len(self.images):
            self._i = 0
        sl = slice(self._i, self._i + batch_size)
        self._i += batch_size
        return self.images[sl], self.maps[sl], None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--dataset", default="synthetic",
                        choices=["salicon", "synthetic"])
    parser.add_argument("--salicon_root", default="salicon",
                        help="the SALICON root of --dataset salicon")
    parser.add_argument("--out", required=True,
                        help="output params file (must not exist)")
    parser.add_argument("--max_steps", default=1000, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--learning_rate", default=3e-5, type=float)
    parser.add_argument("--compute_dtype", default=None,
                        choices=[None, "bfloat16", "float32"])
    parser.add_argument("--train_dir", default=None,
                        help="write the losses to metrics.jsonl here")
    parser.add_argument("--steps_per_logprint", default=50, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if os.path.exists(args.out):
        # fail BEFORE the training run, with the remedy
        log.warn("--out %s already exists and is not overwritten. Remove it "
                 "or pick a fresh path.", args.out)
        return 1
    device = resolve_device(args.device)
    if args.dataset == "salicon":
        train = salicon_data.SaliconData(root=args.salicon_root,
                                         use_val_split=True).build().train
    else:
        train = SyntheticSaliency()
    opt = OptimizerConfig(initial_learning_rate=args.learning_rate,
                          use_decay_schedule=False)
    writer = MetricWriter(args.train_dir) if args.train_dir else None
    try:
        params = fit_shallownet(
            train, opt_cfg=opt, max_steps=args.max_steps,
            batch_size=min(args.batch_size, len(train)),
            compute_dtype=(None if args.compute_dtype is None
                           else getattr(torch, args.compute_dtype)),
            log_every=args.steps_per_logprint, device=device,
            metric_writer=writer)
    finally:
        if writer is not None:
            writer.close()
    save_params(args.out, params)
    log.infov("saved pretrained ShallowNet params to %s", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
