"""Raw video -> C3D -> gaze model in one program: the port's counterpart of
the JAX package's `models/pipeline.py`.

The reference runs C3D as an offline subprocess whose `.c3d` pickles a
later process loads. Here the tower runs on the card in the same program
as the gaze model, for inference (`extract_and_predict`,
`make_fused_predict`, `predict_video`) and for training
(`make_fused_train_step`, the tower frozen or jointly fine-tuned).

Temporal protocol (the reference's loader):
  * C3D features: one timestep per non-overlapping 16-frame window;
  * model frames: every 5th frame from frame 15 ([15::5]), resized to
    98x98 and scaled to [0, 1];
  * both truncated to T = pipeline_timesteps(F).

The gaze model's weights live in its `nn.Module`, the tower's in a dict of
tensors (`models/c3d.py`): where a JAX function takes `gaze_params`, the
port's takes the model. The JAX package's `make_fused_raw_step` is the
un-jitted body it shares with its mesh step; with no jit here,
`make_fused_train_step` is that body, and the mesh step
(`parallel.make_sharded_fused_train_step`) is built from the same loss and
gradient functions.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.layers import resize_bilinear
from ..ops.normalize import normalize_probability_map
from ..train.profiler import span
from . import c3d as c3d_model
from .common import GazeModel, sequence_loss

FRAME_OFFSET = 15
FRAME_STRIDE = 5
WINDOW = 16
FRAME_HW = (98, 98)  # the gaze models' frame size


def pipeline_timesteps(num_frames: int, window: int = WINDOW,
                       frame_offset: int = FRAME_OFFSET,
                       frame_stride: int = FRAME_STRIDE) -> int:
    n_windows = num_frames // window
    n_frames = max(0, (num_frames - frame_offset + frame_stride - 1)
                   // frame_stride)
    return min(n_windows, n_frames)


def extract_and_predict(c3d_params: dict, gaze_model: GazeModel,
                        video_frames: torch.Tensor, *, mean_cube=None,
                        compute_dtype=torch.bfloat16, logits: bool = False,
                        train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        c3d_forward: Optional[Callable] = None,
                        window_constraint: Optional[Callable] = None,
                        stream_constraint: Optional[Callable] = None
                        ) -> torch.Tensor:
    """[B, F, H, W, 3] raw RGB pixels (0..255; uint8 or float, on the
    model's device) -> [B, T, GH, GW] gaze maps (logits when `logits`).

    `c3d_params` follow the RGB-input convention: fold BGR-trained Caffe
    weights through `c3d.fold_bgr_into_params` once at load time.
    `compute_dtype` is the tower's (None = f32). `train=True` applies the
    gaze model's dropout, drawn from `generator`. The tower keeps an
    autograd graph only when one of its weights requires grad (joint
    fine-tuning); a frozen tower runs under no_grad and keeps no
    activations. `c3d_forward(c3d_params, clips) -> [N, 512, 2, 7, 7]`
    replaces the tower (`quant.make_int8_c3d_forward`: the int8 tower).

    Sharding hooks (`parallel/temporal.py` splits the WINDOW axis of one
    long video over the ranks with them), both no-ops by default:
    `window_constraint` maps the folded [B*W, 16, H, W, 3] clip batch to
    the clips this rank runs through the tower (its strip);
    `stream_constraint` maps the tower's features of those clips, folded
    [strip, 1024, 7, 7], to all B*W (an all-gather) before the recurrence.
    The frame stream is computed from the whole video on every rank.
    """
    b, f = video_frames.shape[:2]
    t = pipeline_timesteps(f)
    if t <= 0:
        raise ValueError(f"need >= 16 frames and >= 16 subsampled offset, "
                         f"got F={f}")

    # --- C3D stream: [B*n_windows, 16, H, W, 3] -> conv5b -> fold. Run
    # only for a model that reads the features (not
    # gaze_framewise_shallownet)
    feats = None
    if gaze_model.reads_c3d:
        with span("pipeline.tower"):
            n_windows = f // WINDOW
            clips = video_frames[:, :n_windows * WINDOW].reshape(
                b * n_windows, WINDOW, *video_frames.shape[2:])
            if window_constraint is not None:
                clips = window_constraint(clips)
            clips = c3d_model.preprocess_frames(clips, mean_cube=mean_cube)
            tower_grad = torch.is_grad_enabled() and any(
                p.requires_grad for p in c3d_params.values())
            with torch.set_grad_enabled(tower_grad):
                if c3d_forward is None:
                    feats = c3d_model.apply(c3d_params, clips,
                                            feature_layer="conv5b",
                                            compute_dtype=compute_dtype)
                else:
                    feats = c3d_forward(c3d_params, clips)
            feats = c3d_model.conv5b_to_rgp(feats)  # [B*W, 1024, 7, 7]
            if stream_constraint is not None:
                feats = stream_constraint(feats)
            feats = feats.reshape(b, n_windows, 1024, 7, 7)[:, :t]

    # --- frame stream: [15::5], resized to 98x98, [0, 1] scale. Computed
    # only for a model whose forward reads frames (of the ten families,
    # gaze_framewise_shallownet): the others ignore them, and the JAX
    # package's compiled program drops this dead resize for them too.
    with span("pipeline.head"):
        sub = None
        if gaze_model.reads_frames:
            sub = video_frames[:, FRAME_OFFSET::FRAME_STRIDE][:, :t].float()
            sub = resize_bilinear(sub.reshape(b * t, *sub.shape[2:]),
                                  FRAME_HW).reshape(b, t, *FRAME_HW, 3)
            sub = sub / 255.0

        if logits:
            return gaze_model(sub, feats, train=train, generator=generator)
        return gaze_model.predict(sub, feats)


def make_fused_predict(gaze_model: GazeModel, *, num_frames: int,
                       compute_dtype=torch.bfloat16,
                       c3d_forward: Optional[Callable] = None) -> Callable:
    """`fn(c3d_params, video_frames) -> maps` for a fixed clip length, under
    inference mode: the bulk-inference entry point. Another frame count
    raises. `c3d_forward` replaces the tower, as in
    `extract_and_predict`."""

    @torch.inference_mode()
    def fn(c3d_params: dict, video_frames: torch.Tensor) -> torch.Tensor:
        if video_frames.shape[1] != num_frames:
            raise ValueError(
                f"fused predict built for num_frames={num_frames}, got "
                f"{video_frames.shape[1]}")
        return extract_and_predict(c3d_params, gaze_model, video_frames,
                                   compute_dtype=compute_dtype,
                                   c3d_forward=c3d_forward)

    return fn


def predict_video(c3d_params: dict, gaze_model: GazeModel, video_path: str,
                  *, num_frames: Optional[int] = None,
                  compute_dtype=torch.bfloat16
                  ) -> tuple[torch.Tensor, int]:
    """Video FILE -> per-frame gaze maps on the model's device: decode on
    the host, then one fused predict. `num_frames` fixes the clip length
    (short videos zero-padded, long ones truncated); by default the decoded
    length rounded down to whole 16-frame windows. Returns (maps [T, GH,
    GW], n_valid_timesteps)."""
    from ..data.video import decode_video

    frames = list(decode_video(video_path))
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    stacked = np.stack(frames)
    f_avail = stacked.shape[0]
    f = num_frames if num_frames is not None else (f_avail // 16) * 16
    if f < 16:
        raise ValueError(f"need >= 16 frames, decoded {f_avail}")
    if f_avail >= f:
        stacked = stacked[:f]
    else:  # zero-pad to the fixed length
        pad = np.zeros((f - f_avail,) + stacked.shape[1:], stacked.dtype)
        stacked = np.concatenate([stacked, pad])

    fn = make_fused_predict(gaze_model, num_frames=f,
                            compute_dtype=compute_dtype)
    dev = next(gaze_model.parameters()).device
    maps = fn(c3d_params, torch.from_numpy(stacked).to(dev)[None])
    return maps[0], pipeline_timesteps(min(f_avail, f))


# ----------------------------------------------------------------- training

def flip_half_video_batch(batch: dict,
                          generator: torch.Generator) -> dict:
    """Mirror a random half of a raw-video batch horizontally: video
    [B,F,H,W,3] on W, gazemaps [B,T,GH,GW] on GW (the tower sees the
    flipped pixels)."""
    from ..train.state import random_half_flip

    return random_half_flip(batch, generator, {"video": 3, "gazemaps": 3})


def init_fused_opt_state(tx, gaze_params: dict,
                         c3d_params: Optional[dict] = None, *, c3d_tx=None,
                         finetune_c3d: bool = False):
    """`tx.init(gaze_params)` when the tower is frozen, else the pair
    `(tx.init(gaze_params), (c3d_tx or tx).init(c3d_params))`."""
    if not finetune_c3d:
        return tx.init(gaze_params)
    return (tx.init(gaze_params), (c3d_tx or tx).init(c3d_params))


def make_fused_loss_fn(gaze_model: GazeModel, *,
                       compute_dtype=torch.bfloat16,
                       remat_c3d: bool = False) -> Callable:
    """`loss_fn(c3d_params, batch, generator) -> scalar` over a raw-video
    batch {"video": [B,F,H,W,3], "gazemaps": [B,T,GH,GW]}. `remat_c3d`
    wraps the tower in `torch.utils.checkpoint`, so a backward through it
    recomputes the activations instead of storing them."""
    c3d_fwd = None
    if remat_c3d:
        def c3d_fwd(params, clips):
            return checkpoint(
                lambda x: c3d_model.apply(params, x, feature_layer="conv5b",
                                          compute_dtype=compute_dtype),
                clips, use_reentrant=False)

    def loss_fn(c3d_params: dict, batch: dict,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        logits = extract_and_predict(
            c3d_params, gaze_model, batch["video"],
            compute_dtype=compute_dtype, logits=True, train=True,
            generator=generator, c3d_forward=c3d_fwd)
        gt = batch["gazemaps"]
        if gaze_model.cfg.loss_type in ("xentropy", "kld"):
            gt = normalize_probability_map(gt)
        return sequence_loss(logits, gt, gaze_model.cfg.loss_type)

    return loss_fn


def _tree_map(fn, *trees):
    """fn over the tensors of dicts, or of tuples of dicts."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def make_fused_grads_fn(loss_fn: Callable, *, finetune_c3d: bool,
                        accum_steps: int = 1) -> Callable:
    """`grads(gaze_params, c3d_params, batch, generator) -> (loss, grads)`
    over the fused loss: grads is {name: tensor} for the gaze model, or the
    pair (gaze, c3d) when `finetune_c3d`. A frozen tower is differentiated
    by nothing: it runs on detached weights.

    `accum_steps > 1`: the mean of that many microbatch passes, one result:
    the same mean-over-batch gradient at 1/accum_steps the activation
    memory. Microbatch rows are strided (row j of microbatch i is batch row
    j*accum_steps+i), as in the JAX package.
    """

    def value_and_grad(gaze_params, c3d_params, batch, generator):
        if finetune_c3d:
            c3d_params = {k: v.detach().requires_grad_()
                          for k, v in c3d_params.items()}
            wrt = {**{("gaze", k): v for k, v in gaze_params.items()},
                   **{("c3d", k): v for k, v in c3d_params.items()}}
        else:
            c3d_params = {k: v.detach() for k, v in c3d_params.items()}
            wrt = {("gaze", k): v for k, v in gaze_params.items()}
        with span("train.forward"):
            loss = loss_fn(c3d_params, batch, generator)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, list(wrt.values()),
                                        allow_unused=True)
        by_tree: dict = {"gaze": {}, "c3d": {}}
        for (tree, name), p, g in zip(wrt, wrt.values(), grads):
            by_tree[tree][name] = torch.zeros_like(p) if g is None else g
        if finetune_c3d:
            return loss.detach(), (by_tree["gaze"], by_tree["c3d"])
        return loss.detach(), by_tree["gaze"]

    if accum_steps == 1:
        return value_and_grad

    def grads(gaze_params, c3d_params, batch, generator):
        b = next(iter(batch.values())).shape[0]
        if b % accum_steps:
            raise ValueError(f"batch size {b} not divisible by "
                             f"accum_steps {accum_steps}")
        loss_sum, grad_sum = 0.0, None
        for i in range(accum_steps):
            micro = {k: v.reshape(b // accum_steps, accum_steps,
                                  *v.shape[1:])[:, i]
                     for k, v in batch.items()}
            loss, g = value_and_grad(gaze_params, c3d_params, micro,
                                     generator)
            loss_sum = loss_sum + loss
            grad_sum = g if grad_sum is None else _tree_map(torch.add,
                                                            grad_sum, g)
        inv = 1.0 / accum_steps
        return loss_sum * inv, _tree_map(lambda x: x * inv, grad_sum)

    return grads


def make_fused_train_step(gaze_model: GazeModel, tx, *,
                          finetune_c3d: bool = False, c3d_tx=None,
                          use_flip: Optional[bool] = None,
                          compute_dtype=torch.bfloat16,
                          remat_c3d: Optional[bool] = None,
                          accum_steps: int = 1) -> Callable:
    """Training from raw video: `step(state, batch, generator) -> (state,
    metrics)` with `state` a `train.fused.FusedTrainState` (updated in
    place) and batch {"video": [B,F,H,W,3] pixels 0..255, "gazemaps":
    [B,T,GH,GW]} on the model's device, T = pipeline_timesteps(F). Build
    the optimizer state with `init_fused_opt_state`.

    finetune_c3d=False (the reference's regime): gradients reach only the
    gaze model; the tower runs without an autograd graph. The recurrence
    trains through its kernels, as in the feature-fed step.
    finetune_c3d=True: both trees are differentiated and each gets its own
    update, `c3d_tx` (default `tx`) for the tower; the tower is
    rematerialized by default (`remat_c3d`).

    `generator` (on the model's device) draws the half-batch flip
    (`use_flip`, default cfg.use_flip_batch) and the gaze model's dropout;
    it may be None when both are off. `metrics` holds the loss as a device
    tensor and the new step.
    """
    flip = gaze_model.cfg.use_flip_batch if use_flip is None else use_flip
    c3d_tx = c3d_tx if c3d_tx is not None else tx
    if remat_c3d is None:
        remat_c3d = finetune_c3d
    loss_fn = make_fused_loss_fn(gaze_model, compute_dtype=compute_dtype,
                                 remat_c3d=remat_c3d)
    grads_fn = make_fused_grads_fn(loss_fn, finetune_c3d=finetune_c3d,
                                   accum_steps=accum_steps)

    def step(state, batch: dict, generator: Optional[torch.Generator] = None):
        with span("train.step", request=state.step + 1):
            return _step(state, batch, generator)

    def _step(state, batch: dict, generator: Optional[torch.Generator]):
        if flip:
            with span("train.flip"):
                batch = flip_half_video_batch(batch, generator)
        loss, grads = grads_fn(state.params, state.c3d_params, batch,
                               generator)
        with span("train.optimizer"):
            if finetune_c3d:
                gaze_opt, c3d_opt = state.opt_state
                tx.apply(state.params, grads[0], gaze_opt)
                c3d_tx.apply(state.c3d_params, grads[1], c3d_opt)
            else:
                tx.apply(state.params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "step": state.step}

    return step
