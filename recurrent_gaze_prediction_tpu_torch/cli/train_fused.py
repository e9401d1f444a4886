"""Train a gaze model from raw video on the card, the C3D tower inside the
train step: the port's counterpart of the JAX package's
`cli/train_fused.py`.

    python -m recurrent_gaze_prediction_tpu_torch.cli.train_fused \\
        --dataset synthetic --max_steps 50 --train_dir /tmp/fused

The tower is frozen by default, or fine-tuned jointly with
`--finetune_c3d` (its own Adam at `--c3d_lr`). The gaze recurrence trains
through its kernels where they take it (B1 and B2 for gaze_grcn).
`--c3d_weights` takes a `.caffemodel` (BGR-folded into conv1a at load) or
an `.npz` of the JAX package's flat C3D layout (a bundle's
`c3d_params.npz`). `--shallownet_pretrain` grafts a pretrained ShallowNet
(a file of `cli.pretrain_shallownet`) into a model that has one;
`--freeze_shallownet` keeps it frozen (as in the JAX package's fused
trainer, it trains unless this flag is given).

`--dataset videos` (the default) trains on `--videos_root` (`*.avi` /
`*.mp4`, decoded by cv2 or imageio) with the processed gaze records of
`--gaze_root` (`<clip>.mat` after `cli.process_gazemap`; h5py on the
host), the frames resized on the host to `--frame_hw` (default 128x171)
by `train/fused.load_fused_corpus`.

`--data_parallel N` / `--model_parallel M` (either > 1; data 0 or -1:
every rank left after the model axis) train over a mesh of ranks launched
by torchrun, as `cli.train_gaze` does: the video batch splits over
"data", the tower is replicated, rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ..bridge import c3d_params_from_jax
from ..config import ExperimentConfig
from ..models import c3d as c3d_model
from ..models import pipeline
from ..parallel.mesh import cli_mesh, close_cli_meshes
from ..registry import available_models, create_model
from ..train import (create_train_state, fused, restore_shallownet,
                     schedules)
from ..train.state import Optimizer
from ..train.writer import MetricWriter
from ..utils import log, resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--model", default="gaze_grcn",
                        choices=available_models())
    parser.add_argument("--dataset", default="videos",
                        choices=["videos", "synthetic"])
    parser.add_argument("--videos_root", default=None,
                        help="directory of .avi/.mp4 clips")
    parser.add_argument("--gaze_root", default=None,
                        help="directory of processed gaze .mat files")
    parser.add_argument("--num_frames", default=80, type=int,
                        help="fixed clip length")
    parser.add_argument("--frame_hw", default=None, type=int, nargs=2,
                        help="frame size (default 64x80 for --dataset "
                             "synthetic; 128x171 skips the on-card resize)")
    parser.add_argument("--max_clips", default=None, type=int)
    parser.add_argument("--synthetic_clips", default=8, type=int)
    parser.add_argument("--valid_clips", default=0, type=int,
                        help="hold out the last N clips for validation")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--learning_rate", default=None, type=float)
    parser.add_argument("--max_steps", default=None, type=int)
    parser.add_argument("--steps_per_logprint", default=None, type=int,
                        help="log (and write to metrics.jsonl) every N "
                             "steps; each log reads the loss back")
    parser.add_argument("--loss_type", default=None,
                        choices=[None, "l2", "xentropy", "kld"])
    parser.add_argument("--train_dir", default=None)
    parser.add_argument("--train_tag", "--tag", default="")
    parser.add_argument("--c3d_weights", default=None,
                        help=".caffemodel / .npz Sports-1M weights for the "
                             "tower (random init otherwise)")
    parser.add_argument("--finetune_c3d", action="store_true",
                        help="jointly fine-tune the C3D tower "
                             "(rematerialized in the backward)")
    parser.add_argument("--c3d_lr", default=None, type=float,
                        help="separate LR for the tower under "
                             "--finetune_c3d (default: the gaze LR)")
    parser.add_argument("--shallownet_pretrain", default=None,
                        help="params file to graft into ShallowNet "
                             "(cli.pretrain_shallownet --out)")
    parser.add_argument("--freeze_shallownet", action="store_true",
                        help="keep the ShallowNet subtree frozen")
    parser.add_argument("--data_parallel", default=0, type=int)
    parser.add_argument("--model_parallel", default=1, type=int)
    parser.add_argument("--accum_steps", default=None, type=int,
                        help="gradient-accumulation microbatches per "
                             "optimizer update (batch size must divide)")
    parser.add_argument("--compute_dtype", default=None,
                        choices=[None, "bfloat16", "float32"])
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def load_c3d_params(path: Optional[str], generator: torch.Generator,
                    device: torch.device) -> dict:
    if path is None:
        log.warn("no --c3d_weights: the C3D tower starts from random init "
                 "(fine for smoke runs; pass the Sports-1M checkpoint for "
                 "real training)")
        return c3d_model.init_params(generator, device=device)
    if path.endswith(".npz"):
        # the JAX package's flat layout, assumed already RGB-input
        with np.load(path) as blob:
            params = c3d_params_from_jax(
                {k.replace("/", "_"): blob[k] for k in blob.files})
    else:
        from ..compat.caffemodel import c3d_params_from_caffemodel

        # Caffe-trained weights saw BGR frames; fold the channel reorder
        # into conv1a once
        params = c3d_model.fold_bgr_into_params(
            c3d_params_from_caffemodel(path))
    return {k: v.to(device) for k, v in params.items()}


def main(argv: Optional[list[str]] = None) -> int:
    try:
        return _main(argv)
    finally:
        close_cli_meshes()


def _main(argv: Optional[list[str]]) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dataset == "videos" and not (args.videos_root and
                                         args.gaze_root):
        log.error("--videos_root and --gaze_root are required for "
                  "--dataset videos")
        return 1
    mesh = None
    if args.data_parallel > 1 or args.model_parallel > 1:
        mesh = cli_mesh(args.data_parallel or -1, args.model_parallel,
                        args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)

    t = pipeline.pipeline_timesteps(args.num_frames)
    if t <= 0:
        log.error("--num_frames %d yields no timesteps (need >= 16)",
                  args.num_frames)
        return 1

    exp = ExperimentConfig()
    exp.dataset = args.dataset
    exp.seed = args.seed
    exp.train_dir = args.train_dir
    exp.train_tag = args.train_tag
    exp.model.name = args.model
    exp.apply_overrides({
        "model.batch_size": args.batch_size,
        "model.loss_type": args.loss_type,
        "model.compute_dtype": args.compute_dtype,
        # the unroll length follows the clip length
        "model.n_lstm_steps": t,
        "optimizer.initial_learning_rate": args.learning_rate,
        "optimizer.accum_steps": args.accum_steps,
        "schedule.max_steps": args.max_steps,
        "schedule.steps_per_logprint": args.steps_per_logprint,
    })
    model = create_model(args.model, exp.model, device=device,
                         generator=torch.Generator().manual_seed(exp.seed))
    exp.model = model.cfg

    gazemap_hw = (model.cfg.gazemap_height, model.cfg.gazemap_width)
    if args.dataset == "synthetic":
        corpus = fused.make_synthetic_fused_corpus(
            args.synthetic_clips, num_frames=args.num_frames,
            frame_hw=tuple(args.frame_hw) if args.frame_hw else (64, 80),
            gazemap_hw=gazemap_hw, seed=args.seed)
    else:
        corpus = fused.load_fused_corpus(
            args.videos_root, args.gaze_root, num_frames=args.num_frames,
            frame_hw=tuple(args.frame_hw) if args.frame_hw else (128, 171),
            gazemap_hw=gazemap_hw, max_clips=args.max_clips)
    corpus.shuffle(seed=args.seed or 3027300)
    train_data, valid_data = corpus.split(args.valid_clips)
    log.info("fused corpus: %d train / %d valid clips, F=%d -> T=%d",
             len(train_data), len(valid_data) if valid_data else 0,
             args.num_frames, t)
    if model.cfg.batch_size > len(train_data):
        log.warn("batch_size %d > %d clips; clamping",
                 model.cfg.batch_size, len(train_data))
        model.cfg.batch_size = len(train_data)

    compute_dtype = (None if model.cfg.compute_dtype == "float32"
                     else torch.bfloat16)
    c3d_params = load_c3d_params(
        args.c3d_weights, torch.Generator().manual_seed(exp.seed + 1),
        device)
    if args.shallownet_pretrain:
        restore_shallownet(model, args.shallownet_pretrain)
    gaze_state, tx = create_train_state(
        model, exp.optimizer, freeze_shallownet=args.freeze_shallownet)
    c3d_tx = None
    if args.c3d_lr is not None and not args.finetune_c3d:
        log.warn("--c3d_lr %g has no effect without --finetune_c3d (the "
                 "C3D tower stays frozen)", args.c3d_lr)
    if args.finetune_c3d and args.c3d_lr is not None:
        c3d_tx = Optimizer("adam", schedules.constant(args.c3d_lr))
    state = fused.FusedTrainState(
        params=gaze_state.params,
        opt_state=pipeline.init_fused_opt_state(
            tx, gaze_state.params, c3d_params, c3d_tx=c3d_tx,
            finetune_c3d=args.finetune_c3d),
        c3d_params=c3d_params)

    lead = mesh is None or mesh.rank == 0
    writer = MetricWriter(args.train_dir) if args.train_dir and lead \
        else None
    try:
        state = fused.fit_fused(
            model, state, tx, train_data, exp, valid_data=valid_data,
            finetune_c3d=args.finetune_c3d, c3d_tx=c3d_tx,
            compute_dtype=compute_dtype, train_dir=args.train_dir,
            mesh=mesh, metric_writer=writer)
    finally:
        if writer is not None:
            writer.close()
    log.info("fused training done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
