"""Offline checkpoint evaluation on the card: the port's counterpart of the
JAX package's `cli/evaluate_gaze.py` (the reference's
`models/evaluate_gaze.py:116-227`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.evaluate_gaze \\
        --train_dir /tmp/rgp [--metrics cc sim] [--device cpu]

Loads a run written by `cli.train_gaze` (config.json and the latest
checkpoint), predicts the valid split (synthetic, or up to 500 clip
folders of `--dataset crc|hollywood2|crcxh2` under `--data_root`), scores
every frame with
the saliency metrics (batched on the device, or the NumPy protocol with
`--numpy_protocol`), and writes `overall.txt` (the mean of each metric)
and `scores.txt` (one row per frame) under `--out_dir` (default
`{train_dir}/evaluation`); `--dump_images` also writes each frame's
input, gt and predicted map as PNG. Under `--numpy_protocol` the real-data
fixation maps load at their original scale, as the reference scores them.

`--data_parallel N` (> 1) splits the on-device scoring's frames over a
mesh of N ranks launched by torchrun (`parallel.make_sharded_evaluate`);
every rank predicts the whole valid split first, as the JAX package's
CLI predicts unsharded, and rank 0 alone writes the files.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..data import crc as crc_data
from ..data import synthetic
from ..eval import evaluator, metrics_np, metrics_torch
from ..parallel import make_sharded_evaluate
from ..parallel.mesh import cli_mesh, close_cli_meshes
from ..registry import create_model
from ..train import Checkpointer, create_train_state, make_predict_fn
from ..train.loop import input_dtype_of
from ..utils import log, mkdir_p, resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--dataset", default=None,
                        choices=[None, "crc", "hollywood2", "crcxh2",
                                 "synthetic"],
                        help="override the dataset recorded in config.json")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--num_frames", default=None, type=int,
                        help="cap on evaluated frames (reference "
                             "--num_frames)")
    parser.add_argument("--dump_images", action="store_true")
    parser.add_argument("--on_device", action="store_true", default=True,
                        help="score on the device (the default; accepted "
                             "for the JAX command line)")
    parser.add_argument("--numpy_protocol", dest="on_device",
                        action="store_false", default=True,
                        help="score per frame with the NumPy protocol "
                             "(metrics_np) on the host")
    parser.add_argument("--data_parallel", type=int, default=1)
    parser.add_argument("--sampled_auc", dest="exact", action="store_false",
                        default=True,
                        help="score AUC_Borji/AUC_shuffled with the "
                             "reference's n_rep=100 Monte-Carlo samplers "
                             "instead of their closed-form expectation "
                             "(device path only)")
    parser.add_argument("--metrics", nargs="*",
                        default=list(evaluator.AVAILABLE_METRICS))
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def _dump_images(out_dir: str, ret: dict, limit: int = 200) -> None:
    """The first `limit` frames' predicted and gt maps (each min-max
    normalized) and input frames as PNG."""
    from PIL import Image  # lazy: only --dump_images needs PIL

    def save(path, arr, normalize=True):
        arr = np.asarray(arr, np.float32)
        lo, hi = arr.min(), arr.max()
        if normalize and hi > lo:
            arr = (arr - lo) / (hi - lo)
        Image.fromarray((np.clip(arr, 0.0, 1.0) * 255).astype(
            np.uint8)).save(path)

    for i in range(min(len(ret["pred_gazemaps"]), limit)):
        save(os.path.join(out_dir, f"{i:06d}_pred.png"),
             ret["pred_gazemaps"][i])
        save(os.path.join(out_dir, f"{i:06d}_gt.png"), ret["gt_gazemaps"][i])
        save(os.path.join(out_dir, f"{i:06d}_frame.png"), ret["images"][i],
             normalize=False)


def main(argv: Optional[list[str]] = None) -> int:
    try:
        return _main(argv)
    finally:
        close_cli_meshes()


def _main(argv: Optional[list[str]]) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    exp = Checkpointer.load_config(args.train_dir)
    if args.dataset:
        exp.dataset = args.dataset
    if exp.dataset != "synthetic" and not args.data_root:
        log.error("--data_root is required for dataset %s", exp.dataset)
        return 1
    mesh = (cli_mesh(args.data_parallel, 1, args.device)
            if args.data_parallel > 1 else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)

    model = create_model(exp.model.name, exp.model, device=device)
    state, _ = create_train_state(model, exp.optimizer)
    if Checkpointer(args.train_dir).restore_latest(state) is None:
        log.error("no checkpoint found under %s", args.train_dir)
        return 1

    cfg = model.cfg
    gh, gw = cfg.gazemap_height, cfg.gazemap_width
    if exp.dataset == "synthetic":
        dataset = synthetic.make_splits(
            n_train=2, n_valid=8, n_test=2, t=cfg.n_lstm_steps,
            gazemap_hw=(gh, gw), seed=exp.seed).valid
    else:
        dataset = crc_data.read_crc_data_sets(
            cfg.image_height, cfg.image_width, gh, gw,
            dataset=exp.dataset,
            layouts=crc_data.layouts_for(exp.dataset, args.data_root),
            split_modes="valid", seq_len=cfg.n_lstm_steps,
            fixation_original_scale=not args.on_device,
            max_folders=500).valid
    max_instances = None
    if args.num_frames is not None:
        max_instances = args.num_frames // cfg.n_lstm_steps + 1

    predict = make_predict_fn(model)
    kwargs = dict(batch_size=cfg.batch_size, max_instances=max_instances,
                  input_cast=input_dtype_of(model), device=device)
    if args.on_device and not args.dump_images:
        # maps stay on the device; only the scores come back
        ret = evaluator.generate_on_device(predict, dataset, **kwargs)
    else:
        ret = evaluator.generate(predict, dataset, **kwargs)

    n = len(ret["pred_gazemaps"])
    if args.on_device:
        # one metric pass gives the per-frame scores (reference scores.txt,
        # evaluate_gaze.py:149-158); overall.txt is their nanmean
        maps = [torch.as_tensor(ret[k], device=device) for k in
                ("pred_gazemaps", "gt_gazemaps", "fixationmaps")]
        generator = torch.Generator(device=device).manual_seed(0)
        if mesh is not None:
            per_frame = make_sharded_evaluate(
                mesh, metrics=tuple(args.metrics), exact=args.exact)(
                    *maps, generator)
        else:
            per_frame = metrics_torch.evaluate_batch(
                *maps, generator, metrics=tuple(args.metrics),
                exact=args.exact)
        per_frame = {m: v.cpu().numpy() for m, v in per_frame.items()}
    else:
        # each frame scored once: overall.txt is the nanmean of the very
        # values written to scores.txt (one RNG stream)
        rng = np.random.RandomState(0)
        per_frame = {m: np.asarray(metrics_np.saliency_scores(
            m, ret["pred_gazemaps"], ret["gt_gazemaps"],
            ret["fixationmaps"], rng=rng), np.float64)
            for m in args.metrics}
    scores = {m: float(np.nanmean(v)) for m, v in per_frame.items()}
    if mesh is not None and mesh.rank != 0:
        return 0  # rank 0 writes the files
    for metric, score in scores.items():
        log.infov("Saliency %s : %f", metric, score)

    out_dir = args.out_dir or os.path.join(args.train_dir, "evaluation")
    mkdir_p(out_dir)
    evaluator.write_overall(os.path.join(out_dir, "overall.txt"), scores)
    log.infov("wrote %s", os.path.join(out_dir, "overall.txt"))
    with open(os.path.join(out_dir, "scores.txt"), "w") as f:
        f.write("frame\t" + "\t".join(args.metrics) + "\n")
        for i in range(n):
            row = "\t".join(f"{float(per_frame[m][i]):.6f}"
                            for m in args.metrics)
            f.write(f"{i:06d}\t{row}\n")

    if args.dump_images:
        _dump_images(out_dir, ret)
    return 0


if __name__ == "__main__":
    sys.exit(main())
