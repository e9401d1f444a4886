"""Create action-classification record shards from a trained gaze model:
the port's counterpart of the JAX package's `cli/create_records.py` (the
reference's `models/create_tfrecords.py`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.create_records \\
        --train_dir RUN --out_dir /data/records [--dataset crc --data_root DIR]
        [--clipsets_dir ClipSets] [--device cpu]

Restores the run, predicts each batch of a clip split on the card
(`train.make_predict_fn`), pairs every frame's predicted gazemap with its
C3D features, ground-truth gazemap, frame and Hollywood2 multi-hot labels
(`--clipsets_dir`; zero vectors without it), and writes npz shards of
about `--shard_size` frames (`{split}-{index:05d}.npz`). The dataset is
the run's (or `--dataset`): the synthetic corpus, or CRC / Hollywood2
under `--data_root` (h5py and Pillow on the host).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..action import records
from ..data import crc as crc_data
from ..data import synthetic
from ..data.prefetch import device_put_batch, stream_casts
from ..registry import create_model
from ..train import Checkpointer, create_train_state, make_predict_fn
from ..train.loop import input_dtype_of
from ..utils import log, mkdir_p, resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--split", default="train",
                        choices=["train", "valid", "test"])
    parser.add_argument("--dataset", default=None,
                        choices=[None, "crc", "hollywood2", "crcxh2",
                                 "synthetic"],
                        help="override the dataset recorded in config.json")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--clipsets_dir", default=None,
                        help="Hollywood2 ClipSets dir for labels; without "
                             "it labels are zero vectors")
    parser.add_argument("--shard_size", default=2048, type=int)
    parser.add_argument("--max_instances", default=None, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    mkdir_p(args.out_dir)

    exp = Checkpointer.load_config(args.train_dir)
    if args.dataset:
        exp.dataset = args.dataset
    model = create_model(exp.model.name, exp.model, device=device)
    state, _ = create_train_state(model, exp.optimizer)
    if Checkpointer(args.train_dir).restore_latest(state) is None:
        log.error("no checkpoint under %s", args.train_dir)
        return 1
    predict = make_predict_fn(model)
    cast = stream_casts(input_dtype_of(model))

    gh, gw = model.cfg.gazemap_height, model.cfg.gazemap_width
    if exp.dataset == "synthetic":
        splits = synthetic.make_splits(n_train=8, n_valid=4, n_test=4,
                                       t=model.cfg.n_lstm_steps,
                                       gazemap_hw=(gh, gw), seed=exp.seed)
    else:
        if not args.data_root:
            log.error("--data_root is required for dataset %s", exp.dataset)
            return 1
        splits = crc_data.read_crc_data_sets(
            model.cfg.image_height, model.cfg.image_width, gh, gw,
            dataset=exp.dataset,
            layouts=crc_data.layouts_for(exp.dataset, args.data_root),
            seq_len=model.cfg.n_lstm_steps, split_modes=args.split)
    dataset = getattr(splits, args.split)

    labels_dict = {}
    if args.clipsets_dir:
        labels_dict = records.load_clipset_labels(
            args.clipsets_dir, "train" if args.split == "train" else "test")

    shard_idx = 0
    buf = {k: [] for k in records.FIELDS}

    def flush():
        nonlocal shard_idx
        if not buf["c3d"]:
            return
        path = os.path.join(args.out_dir,
                            f"{args.split}-{shard_idx:05d}.npz")
        records.write_record_shard(
            path, **{k: np.concatenate(v) for k, v in buf.items()})
        log.info("wrote %s (%d frames)", path,
                 sum(len(x) for x in buf["c3d"]))
        for k in buf:
            buf[k].clear()
        shard_idx += 1

    n_frames = 0
    for batch in dataset.iter_batches(model.cfg.batch_size,
                                      args.max_instances):
        inputs = device_put_batch({k: batch[k] for k in ("frames", "c3d")},
                                  device, cast)
        with torch.inference_mode():
            preds = predict(inputs["frames"], inputs["c3d"])
        preds = preds.float().cpu().numpy()
        b, t = preds.shape[:2]
        buf["c3d"].append(batch["c3d"].reshape(b * t, 1024, 7, 7))
        buf["frames"].append(
            batch["frames"].reshape(b * t, *batch["frames"].shape[2:]))
        buf["gaze_pred"].append(preds.reshape(b * t, *preds.shape[2:]))
        buf["gaze_gt"].append(
            batch["gazemaps"].reshape(b * t, *batch["gazemaps"].shape[2:]))
        buf["labels"].append(np.stack([
            records.multi_hot(labels_dict.get(name, []))
            for name in batch["clipnames"] for _ in range(t)]))
        n_frames += b * t
        if sum(len(x) for x in buf["c3d"]) >= args.shard_size:
            flush()
    flush()
    log.infov("serialized %d frames into %d shards", n_frames, shard_idx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
