"""Data- and model-parallel train, predict, streaming and scoring steps:
the port's counterpart of the JAX package's `parallel/sharding.py`.

The JAX package jit-partitions its one-device steps and XLA inserts the
collectives. Here every rank runs the one-device step on its rows and the
collectives are explicit `torch.distributed` calls:

  * train: the loss and the gradients are averaged over the data group in
    one flat all-reduce, so every rank holds the global batch's mean and
    takes the same update; under a model axis the gradient norm of the
    clip sums the column slices' squares over the model group;
  * predict and scoring: the batch (or the frames) is zero-padded to a
    multiple of the data size, each rank runs its rows and the results
    are gathered and cut back.

Random draws of the train steps: the half-batch flip is drawn for the
GLOBAL batch from `generator`, which must be seeded alike on every rank,
and each rank applies its rows of it. Dropout draws from a generator
seeded by (the generator's seed, the data rank): the ranks of one model
group compute the same replicated activations and draw the same masks;
different data ranks draw different ones. So with dropout on, N ranks
match one process in distribution only; with flip and dropout off they
match one process on the same global batch. A mesh of one data rank
draws both from `generator`, as the one-device step does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.common import GazeModel
from ..ops.collectives import (all_gather_cat, all_reduce_, mark_shard,
                               shard_of)
from ..train.state import (FLIP_AXES, Optimizer, TrainState,
                           loss_and_grads, random_half_flip)
from .mesh import (Mesh, _is_rank_shard, _mark_rank_shard, params_shardings,
                   place_params, rank_rows, replicate, shard_batch)


def _pad_batch_dim(tensors, n_data: int):
    """Zero-pad each tensor's leading (batch) dim up to a multiple of the
    data size: tail batches (dataset size % batch, the evaluator's
    max_instances) are routinely short. Returns (padded, original batch);
    None entries pass."""
    b = next(t for t in tensors if t is not None).shape[0]
    pad = (-b) % n_data
    if pad == 0:
        return list(tensors), b
    return [None if t is None else torch.cat(
        [t, t.new_zeros((pad,) + tuple(t.shape[1:]))]) for t in tensors], b


def _as_tensor(x, device: torch.device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=device)


def _on_host_or_device(x) -> Optional[torch.Tensor]:
    """A tensor where `x` lies: a host array becomes a CPU tensor without
    a copy, so only a rank's rows cross to its device."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _opt_states(state) -> list:
    opt = state.opt_state
    return list(opt) if isinstance(opt, (tuple, list)) else [opt]


def _moment_specs(opt: dict, specs: dict) -> dict:
    return {k: ({n: specs.get(n, ()) for n in v} if isinstance(v, dict)
                else ()) for k, v in opt.items()}


def state_shardings(state: TrainState, mesh: Mesh,
                    model_parallel: Optional[bool] = None) -> TrainState:
    """The layouts of a TrainState: the params' per the model-parallel
    rules, each optimizer moment its parameter's, the counts and the step
    replicated (a fused state's tower replicated too)."""
    specs = params_shardings(state.params, mesh, model_parallel)
    opts = [_moment_specs(o, specs) for o in _opt_states(state)]
    return TrainState(params=specs,
                      opt_state=opts[0] if len(opts) == 1 else tuple(opts),
                      step=())


@torch.no_grad()
def place_state(state: TrainState, mesh: Mesh,
                model_parallel: Optional[bool] = None) -> TrainState:
    """Put a TrainState (or a fused one) on the mesh, in place: every
    tensor moved to this rank's device and broadcast from rank 0, then the
    split parameters and their moments cut to this rank's columns. Returns
    it."""
    place_params(state.params, mesh, model_parallel)
    opts = _opt_states(state)
    for opt in opts:
        for v in opt.values():
            if isinstance(v, dict):
                replicate(v, mesh)
    if getattr(state, "c3d_params", None):
        replicate(state.c3d_params, mesh)
    for moments in opts[0].values():
        if not isinstance(moments, dict):
            continue
        for name, t in list(moments.items()):
            shard = shard_of(state.params[name])
            if shard is not None and shard_of(t) is None:
                moments[name] = mark_shard(
                    t[..., shard.columns()].contiguous(), shard)
    state.placed_on = mesh
    return state


def _ensure_placed(state, mesh: Mesh, model_parallel) -> None:
    if getattr(state, "placed_on", None) is not mesh:
        place_state(state, mesh, model_parallel)


class _DropoutDraws:
    """The dropout generator of a data rank: `generator` itself on a mesh
    of one data rank, else a generator seeded by (generator's seed, data
    rank), reseeded whenever that seed changes (the fused loop seeds per
    step)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.own: Optional[torch.Generator] = None
        self.seed: Optional[int] = None

    def __call__(self, generator: Optional[torch.Generator]):
        if generator is None or self.mesh.data == 1:
            return generator
        seed = generator.initial_seed()
        if self.own is None or self.seed != seed:
            self.own = torch.Generator(device=generator.device)
            self.own.manual_seed(hash((seed, self.mesh.data_rank))
                                 & (2 ** 63 - 1))
            self.seed = seed
        return self.own


def _flip(batch: dict, generator, mesh: Mesh, axes: dict) -> dict:
    return random_half_flip(batch, generator, axes, mesh.data,
                            mesh.data_rank)


def mean_over_data(loss: torch.Tensor, grads: list, mesh: Mesh
                   ) -> tuple[torch.Tensor, list]:
    """The loss and gradients averaged over the data group: one all-reduce
    of a flat f32 buffer. Every rank holds the same numbers after it."""
    if mesh.data_group is None:
        return loss, grads
    flat = torch.cat([loss.reshape(1).float()]
                     + [g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh.data_group).div_(mesh.data)
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0], out


def grad_norms(grads: dict, params: dict, trained: list, mesh: Mesh
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(global norm of all gradients, of the trained ones): the column
    slices' squares summed over the model group, the replicated leaves'
    added once, so every rank clips by the same norm."""
    sq = {n: g.float().square().sum() for n, g in grads.items()}
    split = [n for n in sq if shard_of(params[n]) is not None]
    trained = set(trained)
    zero = next(iter(sq.values())).new_zeros(())
    parts = torch.stack([
        sum((sq[n] for n in split), zero),
        sum((sq[n] for n in split if n in trained), zero),
        sum((sq[n] for n in sq if n not in split), zero),
        sum((sq[n] for n in sq if n not in split and n in trained), zero)])
    if split and mesh.model_group is not None:
        parts[:2] = all_reduce_(parts[:2].contiguous(), mesh.model_group)
    return (parts[0] + parts[2]).sqrt(), (parts[1] + parts[3]).sqrt()


def make_sharded_train_step(model: GazeModel, tx: Optimizer, mesh: Mesh, *,
                            use_flip: Optional[bool] = None,
                            model_parallel: Optional[bool] = None
                            ) -> Callable:
    """`step(state, batch, generator) -> (state, metrics)` over the mesh:
    the batch split over "data" (a global batch, or this rank's shard from
    `shard_batch`), the parameters per the model-parallel rules (the state
    is placed at the first call, `place_state`). `metrics` = {"loss",
    "grad_norm", "step"}: the loss is the global batch's mean, the same
    number on every rank. Random draws: the module docstring."""
    flip = model.cfg.use_flip_batch if use_flip is None else use_flip
    dropout_draws = _DropoutDraws(mesh)

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        _ensure_placed(state, mesh, model_parallel)
        batch = shard_batch(batch, mesh)
        if flip:
            batch = _flip(batch, generator, mesh, FLIP_AXES)
        loss, grads = loss_and_grads(model, state.params, batch,
                                     dropout_draws(generator))
        loss, grads = mean_over_data(loss, grads, mesh)
        named = dict(zip(state.params, grads))
        grad_norm, clip_norm = grad_norms(named, state.params,
                                          tx.trained(state.params), mesh)
        tx.apply(state.params, named, state.opt_state, norm=clip_norm)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "step": state.step}

    return step


def make_sharded_eval_step(model: GazeModel, mesh: Mesh) -> Callable:
    """`eval_step(batch) -> {"loss"}`: the validation loss of the global
    batch, split over "data" (no dropout)."""

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        loss, _ = model.loss(shard_batch(batch, mesh), train=False)
        return {"loss": mean_over_data(loss, [], mesh)[0]}

    return eval_step


def _split_rows(tensors, mesh: Mesh):
    """A global batch (padded to the data size) cut to this rank's rows on
    its device, or this rank's shard as it is; returns (rows, b) with b
    the global batch to keep (None: all)."""
    if any(_is_rank_shard(t, mesh) for t in tensors if t is not None):
        return list(tensors), None
    padded, b = _pad_batch_dim([_on_host_or_device(t) for t in tensors],
                               mesh.data)
    rows = rank_rows(next(t for t in padded if t is not None).shape[0], mesh)
    return [None if t is None else t[rows].to(mesh.device) for t in padded], b


def _gather_rows(out: torch.Tensor, mesh: Mesh, b: Optional[int]
                 ) -> torch.Tensor:
    full = all_gather_cat(out, mesh.data_group, dim=0)
    return full if b is None else full[:b]


def make_sharded_predict(model: GazeModel, mesh: Mesh, *,
                         model_parallel: Optional[bool] = None) -> Callable:
    """`predict(frames, c3d) -> maps` over the mesh, the bulk
    `extract_map`-style path: a global batch of any size is zero-padded to
    a multiple of the data size, each rank predicts its rows, and every
    rank returns the gathered maps of the first b rows (a batch that is
    already this rank's shard returns all ranks' rows)."""

    @torch.inference_mode()
    def predict(frames, c3d):
        _ensure_params_placed(model, mesh, model_parallel)
        (frames, c3d), b = _split_rows((frames, c3d), mesh)
        return _gather_rows(model.predict(frames, c3d), mesh, b)

    return predict


def tower_on(mesh: Mesh, c3d_params: dict, cache: dict) -> dict:
    """The tower's weights on this rank's device, moved once per weights
    dict (kept in `cache`)."""
    entry = cache.get(id(c3d_params))
    if entry is None or entry[0] is not c3d_params:
        entry = cache[id(c3d_params)] = (c3d_params, {
            k: v.to(mesh.device) for k, v in c3d_params.items()})
    return entry[1]


def _ensure_params_placed(model: GazeModel, mesh: Mesh,
                          model_parallel) -> None:
    place_params(dict(model.named_parameters()), mesh, model_parallel)


def make_sharded_stream_fn(cfg, mesh: Mesh, *,
                           model_parallel: Optional[bool] = None
                           ) -> Callable:
    """Chunked streaming over a BATCH OF STREAMS split over "data":
    `step(model, state, c3d_chunk) -> (state, logits)`, the port's
    `grcn_stream_step` on each rank's streams (`cfg` is the model's
    config). State [B,7,7,U] and chunk [B,Tc,1024,7,7] are global, or
    this rank's shards; the returned state and logits are this rank's
    shards, so the carried state never leaves its rank and a chunk
    boundary costs no collective."""
    from ..models.streaming import grcn_stream_step

    def step(model: GazeModel, state, c3d_chunk):
        if model.cfg.rnn_state_size != cfg.rnn_state_size:
            raise ValueError(f"stream step built for U={cfg.rnn_state_size},"
                             f" model has U={model.cfg.rnn_state_size}")
        _ensure_params_placed(model, mesh, model_parallel)
        local = shard_batch({"state": state, "c3d": c3d_chunk}, mesh)
        new_state, logits = grcn_stream_step(model, local["state"],
                                             local["c3d"])
        return (_mark_rank_shard(new_state, mesh),
                _mark_rank_shard(logits, mesh))

    return step


def make_sharded_fused_predict(gaze_model: GazeModel, mesh: Mesh, *,
                               compute_dtype=None,
                               model_parallel: Optional[bool] = None
                               ) -> Callable:
    """Raw-video bulk inference over the mesh: `fn(c3d_params, video) ->
    maps`, the fused program (`models/pipeline.extract_and_predict`) with
    the video batch split over "data" (zero-padded to the data size, the
    maps gathered and cut back on every rank). The tower's weights are
    replicated (moved to this rank's device once)."""
    from ..models.pipeline import extract_and_predict

    cdt = torch.bfloat16 if compute_dtype is None else compute_dtype
    towers: dict = {}

    @torch.inference_mode()
    def fn(c3d_params: dict, video_frames) -> torch.Tensor:
        _ensure_params_placed(gaze_model, mesh, model_parallel)
        (video,), b = _split_rows((video_frames,), mesh)
        out = extract_and_predict(tower_on(mesh, c3d_params, towers),
                                  gaze_model, video, compute_dtype=cdt)
        return _gather_rows(out, mesh, b)

    return fn


def make_sharded_fused_train_step(gaze_model: GazeModel, tx: Optimizer,
                                  mesh: Mesh, *, finetune_c3d: bool = False,
                                  c3d_tx: Optional[Optimizer] = None,
                                  use_flip: Optional[bool] = None,
                                  compute_dtype=None,
                                  model_parallel: Optional[bool] = None,
                                  remat_c3d: Optional[bool] = None,
                                  accum_steps: int = 1) -> Callable:
    """Raw-video training over the mesh: `models/pipeline.
    make_fused_train_step`'s `step(state, batch, generator) -> (state,
    metrics)` with the video batch split over "data", the gaze model's
    parameters per the model-parallel rules and the C3D tower replicated.
    With `finetune_c3d` the tower's gradients are averaged over the data
    group with the gaze ones (one all-reduce); a frozen tower passes
    through untouched. `accum_steps` microbatches each rank's rows, so the
    global batch must divide by data size x accum_steps."""
    from ..models import pipeline

    flip = gaze_model.cfg.use_flip_batch if use_flip is None else use_flip
    c3d_tx = c3d_tx if c3d_tx is not None else tx
    if remat_c3d is None:
        remat_c3d = finetune_c3d
    cdt = torch.bfloat16 if compute_dtype is None else compute_dtype
    loss_fn = pipeline.make_fused_loss_fn(gaze_model, compute_dtype=cdt,
                                          remat_c3d=remat_c3d)
    grads_fn = pipeline.make_fused_grads_fn(loss_fn,
                                            finetune_c3d=finetune_c3d,
                                            accum_steps=accum_steps)
    dropout_draws = _DropoutDraws(mesh)

    def step(state, batch: dict, generator: Optional[torch.Generator] = None):
        _ensure_placed(state, mesh, model_parallel)
        b = next(v for k, v in batch.items() if k != "clipnames").shape[0]
        if not _is_rank_shard(batch.get("video"), mesh) and \
                b % (mesh.data * accum_steps):
            raise ValueError(f"batch_size {b} not divisible by data axis * "
                             f"accum_steps ({mesh.data} * {accum_steps})")
        batch = shard_batch(batch, mesh)
        if flip:
            batch = _flip(batch, generator, mesh, {"video": 3, "gazemaps": 3})
        loss, grads = grads_fn(state.params, state.c3d_params, batch,
                               dropout_draws(generator))
        trees = [grads] if not finetune_c3d else list(grads)
        names = [list(g) for g in trees]
        loss, flat = mean_over_data(
            loss, [t for g in trees for t in g.values()], mesh)
        at, averaged = 0, []
        for keys in names:
            averaged.append(dict(zip(keys, flat[at:at + len(keys)])))
            at += len(keys)
        opts = _opt_states(state)
        for params, g, opt, t in zip(
                (state.params, state.c3d_params), averaged, opts,
                (tx, c3d_tx)):
            _, clip_norm = grad_norms(g, params, t.trained(params), mesh)
            t.apply(params, g, opt, norm=clip_norm)
        state.step += 1
        return state, {"loss": loss, "step": state.step}

    return step


def make_sharded_evaluate(mesh: Mesh, *, metrics=None, max_fix: int = 64,
                          n_rep: int = 100, exact: bool = True) -> Callable:
    """Frame-parallel saliency scoring over "data": `evaluate(pred, gt,
    fixation, generator=None, other_map=None) -> {metric: [N]}` on every
    rank, each rank scoring its strip of the (replicated) frames with
    `metrics_torch.evaluate_batch`.

    The two couplings across frames hold as in one process: the
    AUC_shuffled other-map union is built from the FULL fixation
    population (`evaluation_metrics.py:283-287`), from `generator` seeded
    alike on every rank, so it is the same everywhere; the AUC capacity
    preamble is a global max (an all-reduce MAX of the strips' densest
    maps). N is padded to a multiple of the data size with empty fixation
    maps, which are sliced off before returning."""
    from ..eval import metrics_torch

    metrics = tuple(metrics if metrics is not None
                    else metrics_torch.AVAILABLE_METRICS)

    @torch.no_grad()
    def evaluate(pred, gt, fixation, generator=None, other_map=None):
        pred, gt, fixation = (_as_tensor(x, mesh.device)
                              for x in (pred, gt, fixation))
        pred = pred.reshape(pred.shape[0], *pred.shape[-2:])
        gen = generator
        if gen is None:
            gen = torch.Generator(device=mesh.device).manual_seed(0)
        if other_map is None:
            other_map = (metrics_torch.build_other_map_union(fixation, gen)
                         if "AUC_shuffled" in metrics
                         else fixation.new_zeros(fixation.shape[-2:]))
        (pred, gt, fixation), n = _pad_batch_dim((pred, gt, fixation),
                                                 mesh.data)
        rows = rank_rows(pred.shape[0], mesh)
        pred, gt, fixation = pred[rows], gt[rows], fixation[rows]
        cap = max_fix
        if "AUC_Judd" in metrics or (not exact and any(
                m.startswith("AUC") for m in metrics)):
            densest = (fixation.reshape(fixation.shape[0], -1) > 0.5).sum(
                dim=-1).max().reshape(1)
            densest = int(all_reduce_(densest, mesh.data_group,
                                      torch.distributed.ReduceOp.MAX))
            if densest > cap:
                cap = 1 << (densest - 1).bit_length()
        out = metrics_torch.evaluate_batch(
            pred, gt, fixation, gen, metrics=metrics, other_map=other_map,
            max_fix=cap, n_rep=n_rep, exact=exact)
        return {m: _gather_rows(v, mesh, n) for m, v in out.items()}

    return evaluate
