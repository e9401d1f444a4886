"""Training from raw video: the port's counterpart of the JAX package's
`train/fused.py`.

The C3D tower runs in the train step (`models/pipeline.
make_fused_train_step`), so a run needs video, not pre-extracted features,
and the tower can be fine-tuned jointly. This module holds what the CLI
(`cli/train_fused.py`) wires up:

  * `RawVideoDataset`: fixed-shape uint8 clips and aligned gazemaps;
  * `load_fused_corpus`: a directory of videos with their processed gaze
    `.mat` records (h5py, and cv2 or imageio to decode), into one;
  * `make_synthetic_fused_corpus`: a learnable stand-in corpus, with the
    JAX package's numpy draws (the same seed gives the same arrays);
  * `FusedTrainState` and `fit_fused`: the checkpointed, resumable loop,
    on one device or over a mesh (`parallel.make_mesh`).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.prefetch import device_put_batch
from ..models import pipeline
from ..models.common import GazeModel, sequence_loss
from ..ops.layers import resize_bilinear
from ..ops.normalize import normalize_probability_map
from ..utils import log
from .checkpoint import Checkpointer
from .state import Optimizer, TrainState, build_schedule


@dataclasses.dataclass
class RawVideoDataset:
    """Raw-pixel clips at a fixed frame count.

    video    [N, F, H, W, 3] uint8 pixels (the train step widens them on
             the card)
    gazemaps [N, T, GH, GW]  float32, T = pipeline_timesteps(F)
    """

    video: np.ndarray
    gazemaps: np.ndarray
    clipnames: list

    def __post_init__(self):
        if len(self.video) != len(self.gazemaps):
            raise ValueError(f"{len(self.video)} clips but "
                             f"{len(self.gazemaps)} gazemap sequences")
        t = pipeline.pipeline_timesteps(self.video.shape[1])
        if self.gazemaps.shape[1] != t:
            raise ValueError(f"gazemaps T={self.gazemaps.shape[1]} does not "
                             f"match pipeline_timesteps("
                             f"{self.video.shape[1]})={t}")
        self._index = 0
        self.epochs_completed = 0

    def __len__(self) -> int:
        return len(self.video)

    def shuffle(self, seed: int = 3027300) -> None:
        perm = np.random.RandomState(seed).permutation(len(self))
        self.video = self.video[perm]
        self.gazemaps = self.gazemaps[perm]
        self.clipnames = [self.clipnames[i] for i in perm]

    def next_batch(self, batch_size: int) -> dict:
        if batch_size > len(self):
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{len(self)}")
        start = self._index
        self._index += batch_size
        if self._index > len(self):
            self.epochs_completed += 1
            start = 0
            self._index = batch_size
        end = self._index
        return {"video": self.video[start:end],
                "gazemaps": self.gazemaps[start:end],
                "clipnames": self.clipnames[start:end]}

    def split(self, n_valid: int) -> tuple["RawVideoDataset",
                                           Optional["RawVideoDataset"]]:
        """Hold out the LAST n_valid clips as a validation set."""
        if n_valid <= 0 or n_valid >= len(self):
            return self, None
        cut = len(self) - n_valid
        return (RawVideoDataset(self.video[:cut], self.gazemaps[:cut],
                                self.clipnames[:cut]),
                RawVideoDataset(self.video[cut:], self.gazemaps[cut:],
                                self.clipnames[cut:]))


def make_synthetic_fused_corpus(n_clips: int = 8, *, num_frames: int = 80,
                                frame_hw: tuple[int, int] = (64, 80),
                                gazemap_hw: tuple[int, int] = (49, 49),
                                seed: int = 0, mode: str = "bright",
                                walk_bounds: Optional[tuple] = None
                                ) -> RawVideoDataset:
    """Learnable raw-video corpus: the gaze target tracks a blob walking
    across gray-noise frames.

    mode="bright": one saturated-white blob; any spatially selective
    encoding (even a random frozen tower) carries its position.
    mode="flicker": two equal-mean blobs walk independently; the target
    flickers frame to frame (+-60 around 120), the distractor holds 120.
    mode="period": both flicker, the target every frame (+-35), the
    distractor every 2 frames (+-70), with +-15 global brightness jitter.

    `walk_bounds` clamps the normalized walk; `c3d.preprocess_frames`
    center-crops 112/171 of the width, so positions outside ~[0.18, 0.82]
    horizontally leave the tower's view.
    """
    if mode not in ("bright", "flicker", "period"):
        raise ValueError(f"unknown corpus mode {mode!r}")
    rng = np.random.RandomState(seed)
    fh, fw = frame_hw
    gh, gw = gazemap_hw
    t = pipeline.pipeline_timesteps(num_frames)
    lo, hi = walk_bounds if walk_bounds is not None else (
        (0.15, 0.85) if mode == "bright" else (0.25, 0.75))

    def walk(key_offset: int = 0) -> np.ndarray:
        wrng = np.random.RandomState(seed + key_offset)
        pos = wrng.rand(n_clips, 2) * (hi - lo - 0.2) + lo + 0.1
        steps = np.zeros((n_clips, num_frames, 2))
        for step in range(num_frames):
            pos = np.clip(pos + wrng.randn(n_clips, 2) * 0.01, lo, hi)
            steps[:, step] = pos
        return steps

    traj = walk()
    video = rng.randint(0, 70, (n_clips, num_frames, fh, fw, 3),
                        np.uint8)
    r = max(2, fh // 12)

    def draw(blob_traj: np.ndarray, brightness) -> None:
        """brightness: scalar or per-frame array [num_frames]."""
        ys = (blob_traj[..., 0] * (fh - 1)).astype(int)
        xs = (blob_traj[..., 1] * (fw - 1)).astype(int)
        for ci in range(n_clips):
            for fi in range(num_frames):
                y0, x0 = ys[ci, fi], xs[ci, fi]
                bval = brightness if np.isscalar(brightness) \
                    else brightness[fi]
                video[ci, fi, max(0, y0 - r):y0 + r,
                      max(0, x0 - r):x0 + r] = bval

    frames_idx = np.arange(num_frames)
    if mode == "bright":
        draw(traj, 255)
    elif mode == "flicker":
        flick = 120 + 60 * np.where(frames_idx % 2 == 0, 1, -1)
        draw(traj, flick)           # target: mean 120, flickering
        draw(walk(key_offset=777), 120)  # distractor: steady 120
    else:  # period
        fast = 120 + 35 * np.where(frames_idx % 2 == 0, 1, -1)
        slow = 120 + 70 * np.where((frames_idx // 2) % 2 == 0, 1, -1)
        draw(walk(key_offset=777), slow)  # distractor first ...
        draw(traj, fast)  # ... so the target overdraws on overlap
        # global jitter AFTER drawing: every pixel, every frame
        jit = rng.randint(-15, 16, (n_clips, num_frames, 1, 1, 1))
        video = np.clip(video.astype(np.int16) + jit, 0, 255) \
            .astype(np.uint8)

    sub = traj[:, pipeline.FRAME_OFFSET::pipeline.FRAME_STRIDE][:, :t]
    yy = np.arange(gh).reshape(1, 1, gh, 1)
    xx = np.arange(gw).reshape(1, 1, 1, gw)
    cy = (sub[..., 0] * (gh - 1))[..., None, None]
    cx = (sub[..., 1] * (gw - 1))[..., None, None]
    gaze = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0 ** 2))
    gaze = gaze.astype(np.float32) + 1e-4
    names = [f"synthetic{ci:04d}" for ci in range(n_clips)]
    return RawVideoDataset(video, gaze, names)


def _gaze_targets_for_clip(mat_path: str, num_frames: int,
                           gazemap_hw: tuple[int, int]) -> np.ndarray:
    """Per-frame mean-over-users blurred gazemaps, subsampled to the fused
    pipeline's T. Follows the CRC loader protocol (`data/crc.read_clip`,
    `crc_input_data_seq.py:271-295`): mean of per-user resolution-matched
    maps, missing frames filled, Gaussian blur at the resolution's sigma."""
    import h5py

    from ..data.gazemap import (apply_gaussian_filter, fill_missing_frames,
                                gazemap_key_and_sigma)

    gh, gw = gazemap_hw
    key, sigma = gazemap_key_and_sigma(gh, gw)
    t = pipeline.pipeline_timesteps(num_frames)
    with h5py.File(mat_path, "r") as mat:
        # the root group's name is whatever MATLAB wrote, not necessarily
        # "data" (as in data/crc.read_clip)
        root = list(mat.values())[0]
        users = []
        for name in root.keys():
            user = root[name]
            if key not in user:
                log.warn("%s: user %s lacks %s — run cli/process_gazemap "
                         "over the corpus first", mat_path, name, key)
                continue
            if "pupilsize" in user and np.isnan(
                    np.min(np.asarray(user["pupilsize"]))):
                continue  # a tracking-dropout user (as crc.read_clip)
            users.append(np.asarray(user[key], np.float32))
    if not users:
        raise ValueError(f"{mat_path}: no usable users with {key}")
    # the gazelen heuristic and the per-user [15::5] subsample BEFORE the
    # mean, as data/crc.read_clip (crc_input_data_seq.py:261-280)
    if len(users) >= 2:
        gazelen = max(len(users[0]), len(users[1])) - 10
    else:
        gazelen = len(users[0]) - 10
    subs = [u[pipeline.FRAME_OFFSET:gazelen:pipeline.FRAME_STRIDE]
            for u in users if len(u) > gazelen - 1]
    if not subs:
        raise ValueError(f"{mat_path}: no gaze record of length >= {gazelen}")
    mean = np.mean(np.asarray(subs, dtype=np.float32), axis=0)
    # records store (W, H); training targets are (H, W)
    mean = np.swapaxes(mean, 1, 2).copy()
    if len(mean) and mean.reshape(len(mean), -1).sum(axis=1).min() == 0:
        mean = fill_missing_frames(mean)
    apply_gaussian_filter(mean, sigma)
    sub = mean[:t]
    if len(sub) < t:  # video padded past the gaze record: repeat last map
        pad = np.repeat(sub[-1:] if len(sub) else
                        np.full((1, gh, gw), 1.0 / (gh * gw), np.float32),
                        t - len(sub), axis=0)
        sub = np.concatenate([sub, pad]) if len(sub) else pad
    return sub.astype(np.float32) + 1e-6


def load_fused_corpus(videos_root: str, gaze_root: str, *,
                      num_frames: int = 80,
                      frame_hw: tuple[int, int] = (128, 171),
                      gazemap_hw: tuple[int, int] = (49, 49),
                      max_clips: Optional[int] = None) -> RawVideoDataset:
    """Decode `{videos_root}/*.avi|*.mp4` and read `{gaze_root}/<clip>.mat`.

    Videos are truncated or zero-padded to `num_frames` (a fixed shape, as
    `cli/extract_map.py` does) and resized on the host to `frame_hw`: by
    default 128x171, the C3D VIDEO_DATA resize target
    (`extract_C3D_features.py:204-216`), so the step skips its on-card
    resize and the copy carries the fewest uint8 bytes. A clip without a
    gaze record, without frames or whose record has no usable map is
    skipped with a warning.
    """
    from ..data import video as video_lib

    paths = sorted(glob.glob(os.path.join(videos_root, "*.avi")) +
                   glob.glob(os.path.join(videos_root, "*.mp4")))
    if max_clips:
        paths = paths[:max_clips]
    if not paths:
        raise ValueError(f"no videos under {videos_root}")
    fh, fw = frame_hw
    vids, gazes, names = [], [], []
    for path in paths:
        clip = os.path.splitext(os.path.basename(path))[0]
        mat_path = os.path.join(gaze_root, clip + ".mat")
        if not os.path.exists(mat_path):
            log.warn("skipping %s: no gaze record %s", clip, mat_path)
            continue
        frames = []
        for frame in video_lib.decode_video(path):
            frames.append(_resize_uint8(frame, fh, fw))
            if len(frames) >= num_frames:
                break
        if not frames:
            log.warn("skipping %s: decoded no frames", clip)
            continue
        stacked = np.stack(frames)
        if len(stacked) < num_frames:
            pad = np.zeros((num_frames - len(stacked),) + stacked.shape[1:],
                           stacked.dtype)
            stacked = np.concatenate([stacked, pad])
        try:
            gaze = _gaze_targets_for_clip(mat_path, num_frames, gazemap_hw)
        except ValueError as e:
            # e.g. an all-zero record (`gazemap.fill_missing_frames`
            # raises): skip the clip, as data/crc.read_clip does
            log.warn("skipping %s: %s", clip, e)
            continue
        vids.append(stacked)
        gazes.append(gaze)
        names.append(clip)
    if not vids:
        raise ValueError(f"no usable (video, gaze) pairs under "
                         f"{videos_root} / {gaze_root}")
    return RawVideoDataset(np.stack(vids), np.stack(gazes), names)


def _resize_uint8(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, 3] -> [h, w, 3] uint8: cv2's INTER_LINEAR where cv2 imports,
    else the JAX package's fallback, `jax.image.resize(..., "bilinear")`
    (antialiased when it shrinks: `ops.layers.resize_bilinear`),
    clipped and truncated to uint8."""
    if frame.shape[:2] == (h, w):
        return frame.astype(np.uint8)
    try:
        import cv2
    except ImportError:
        out = resize_bilinear(torch.from_numpy(
            frame.astype(np.float32))[None], (h, w))[0]
        return np.clip(out.numpy(), 0, 255).astype(np.uint8)
    return cv2.resize(frame, (w, h),
                      interpolation=cv2.INTER_LINEAR).astype(np.uint8)


# ------------------------------------------------------------- train state

@dataclasses.dataclass
class FusedTrainState(TrainState):
    """`TrainState` with the tower: `params` are the gaze model's (the JAX
    package's `gaze_params`), `c3d_params` the tower's dict of tensors,
    `opt_state` one optimizer state, or the pair (gaze, c3d) when the
    tower is fine-tuned."""

    c3d_params: dict = dataclasses.field(default_factory=dict)


def make_fused_eval_step(gaze_model: GazeModel, *,
                         compute_dtype=torch.bfloat16, mesh=None) -> Callable:
    """Validation loss on raw-video batches (no dropout, no flip):
    `eval_step(c3d_params, batch) -> {"loss"}`. With a `mesh`, `batch` is
    this rank's shard and the loss the mean over the data group."""

    @torch.no_grad()
    def eval_step(c3d_params: dict, batch: dict) -> dict:
        if mesh is not None:
            from ..parallel.sharding import mean_over_data

            return {"loss": mean_over_data(local_loss(c3d_params, batch),
                                           [], mesh)[0]}
        return {"loss": local_loss(c3d_params, batch)}

    def local_loss(c3d_params: dict, batch: dict) -> torch.Tensor:
        logits = pipeline.extract_and_predict(
            c3d_params, gaze_model, batch["video"],
            compute_dtype=compute_dtype, logits=True, train=False)
        gt = batch["gazemaps"]
        if gaze_model.cfg.loss_type in ("xentropy", "kld"):
            gt = normalize_probability_map(gt)
        return sequence_loss(logits, gt, gaze_model.cfg.loss_type)

    return eval_step


def fit_fused(gaze_model: GazeModel, state: FusedTrainState, tx: Optimizer,
              train_data: RawVideoDataset, exp: ExperimentConfig, *,
              valid_data: Optional[RawVideoDataset] = None,
              finetune_c3d: bool = False, c3d_tx: Optional[Optimizer] = None,
              compute_dtype=torch.bfloat16, train_dir: Optional[str] = None,
              mesh=None,
              metric_writer: Optional[Callable[[int, dict], None]] = None
              ) -> FusedTrainState:
    """Train the fused raw-video step until `exp.schedule.max_steps`.

    `train/loop.fit`'s contract on the fused step: the reference's log
    cadence, periodic and final checkpoints with auto-resume (both weight
    trees and the optimizer state or states, so a resumed joint fine-tune
    continues exactly), checkpoint-and-stop on SIGTERM/SIGINT. The flip and
    dropout draw from a generator on the model's device seeded from
    (exp.seed, step), so a resumed run at step N draws what the
    uninterrupted one would have.

    `mesh` switches the step to `parallel.make_sharded_fused_train_step`
    (every rank calls `fit_fused` alike): the video batch splits over
    "data", the gaze model's wide weights follow the model-parallel rules,
    the tower is replicated; batch_size must divide by the data size (and
    by data size x accum_steps). Rank 0 alone logs and writes.
    """
    sched_cfg = exp.schedule
    batch_size = gaze_model.cfg.batch_size
    lr_schedule = build_schedule(exp.optimizer)
    accum = max(int(exp.optimizer.accum_steps or 1), 1)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        from ..parallel import (make_sharded_fused_train_step, place_state,
                                shard_batch)

        if batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the data axis ({mesh.data})")
        if accum > 1 and batch_size % (mesh.data * accum):
            # each microbatch has batch_size/accum rows; those rows must
            # still split evenly over the data axis
            raise ValueError(
                f"batch_size {batch_size} not divisible by data axis * "
                f"accum_steps ({mesh.data} * {accum}); microbatches would be "
                f"unbalanced across data shards")
        place_state(state, mesh)
        train_step = make_sharded_fused_train_step(
            gaze_model, tx, mesh, finetune_c3d=finetune_c3d, c3d_tx=c3d_tx,
            compute_dtype=compute_dtype, accum_steps=accum)
        device = mesh.device
        metric_writer = metric_writer if lead else None

        def put(batch: dict) -> dict:
            return shard_batch(batch, mesh)
    else:
        train_step = pipeline.make_fused_train_step(
            gaze_model, tx, finetune_c3d=finetune_c3d, c3d_tx=c3d_tx,
            compute_dtype=compute_dtype, accum_steps=accum)
        device = next(gaze_model.parameters()).device

        def put(batch: dict) -> dict:
            return device_put_batch(batch, device)
    generator = torch.Generator(device=device)
    eval_step = make_fused_eval_step(gaze_model, compute_dtype=compute_dtype,
                                     mesh=mesh)

    ckpt = None
    if train_dir is not None:
        ckpt = Checkpointer(train_dir, mesh=mesh)
        ckpt.save_config(exp)
        if ckpt.restore_latest(state) is not None and lead:
            log.info(" [Checkpoint] resumed fused run at step %d", state.step)

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        del frame
        log.warn("signal %s received: checkpointing and stopping", signum)
        stop_requested["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread
            pass

    has_valid = valid_data is not None and len(valid_data) >= batch_size
    if valid_data is not None and not has_valid and lead:
        log.warn("validation set has %d clips < batch_size %d: validation "
                 "will never run", len(valid_data), batch_size)
    n_train = max(len(train_data), 1)
    step = state.step
    last_logged_step, t_logged = step, time.time()
    try:
        stop = False  # under a mesh, agreed by the ranks at each log
        while step < sched_cfg.max_steps and not stop:
            batch = put(train_data.next_batch(batch_size))
            generator.manual_seed(exp.seed * 1_000_003 + step)
            state, metrics = train_step(state, batch, generator)
            step = state.step

            stop = stop_requested["flag"]
            if mesh is not None:
                stop = (step % sched_cfg.steps_per_logprint == 0
                        and mesh.any_rank(stop))
            if step % sched_cfg.steps_per_logprint == 0:
                loss = float(metrics["loss"])  # the card syncs HERE
                t1 = time.time()
                sec_per_batch = (t1 - t_logged) / max(step - last_logged_step,
                                                      1)
                last_logged_step, t_logged = step, t1
                lr = lr_schedule(step)
                if lead:
                    log.info(
                        " [fused epoch %.1f / step %4d] %s loss: %.5f "
                        "(%.3f sec/batch, %.3f instances/sec) (lr=%.3g)",
                        step * batch_size / n_train, step,
                        (exp.train_tag + " |" if exp.train_tag else ""),
                        loss, sec_per_batch,
                        batch_size / max(sec_per_batch, 1e-9), lr)
                if metric_writer:
                    metric_writer(step, {"loss/train": loss,
                                         "learning_rate": lr})

            if ckpt is not None and step % sched_cfg.steps_per_checkpoint == 0:
                ckpt.save(state)

            if has_valid and step % sched_cfg.steps_per_validation == 0:
                vbatch = put(valid_data.next_batch(batch_size))
                vloss = float(eval_step(state.c3d_params, vbatch)["loss"])
                if lead:
                    log.infov(" [val   step %4d] fused loss: %.5f", step,
                              vloss)
                if metric_writer:
                    metric_writer(step, {"loss/val": vloss})

        if ckpt is not None:
            ckpt.save(state)
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state
