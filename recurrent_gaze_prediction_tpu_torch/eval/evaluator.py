"""Generate and evaluate: the port's counterpart of the JAX package's
`eval/evaluator.py` (the reference's inference and scoring path,
`models/gaze_rnn.py:568-680`).

Batched inference over a dataset, the time axis flattened so there is one
map per frame, then the saliency metrics: batched on the card
(`metrics_torch`), or the NumPy protocol (`metrics_np`) for
original-scale fixation maps (`models/evaluate_gaze.py`). Inputs are cast
on the host (`input_cast`) and copied as the trainer copies them
(`data.prefetch.device_put_batch`).

`predict_fn(frames, c3d)` is the port's predict (`train.make_predict_fn`,
or `parallel.make_sharded_predict` over a mesh): the model's weights live
in the model, so there is no `params` argument. `mesh` (a
`parallel.make_mesh` mesh, every rank calling alike) splits the scoring's
frames over its "data" axis (`parallel.make_sharded_evaluate`); the
scores are the same on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..data.datasets import ClipDataset
from ..data.prefetch import device_put_batch, stream_casts
from ..utils import log, resolve_device
from . import metrics_np, metrics_torch

AVAILABLE_METRICS = metrics_torch.AVAILABLE_METRICS

Device = Optional[Union[str, torch.device]]


class RaggedMapsError(ValueError):
    """Fixation maps are ragged (original-scale, mixed resolutions), so the
    on-device path cannot form one rectangular tensor. Callers catch THIS,
    not bare ValueError, so unrelated errors from predict_fn or the data
    pipeline propagate instead of silently re-running the epoch on the
    host path."""


def _predict(predict_fn: Callable, batch: dict, device: torch.device,
             input_cast: Optional[torch.dtype]) -> torch.Tensor:
    inputs = device_put_batch({k: batch[k] for k in ("frames", "c3d")},
                              device, stream_casts(input_cast))
    return predict_fn(inputs["frames"], inputs["c3d"])


def _frame_names(batch: dict, t: int) -> list:
    # one name per FRAME, aligned with the flattened per-frame stacks
    return [n for n in batch["clipnames"] for _ in range(t)]


def generate(predict_fn: Callable, dataset: ClipDataset, batch_size: int,
             max_instances: Optional[int] = 50,
             input_cast: Optional[torch.dtype] = None,
             device: Device = None) -> dict:
    """Batched inference on `device` (None = the card); returns NumPy
    per-frame stacks (time axis flattened) with the frame images, as
    `gaze_rnn.py:568-650` does."""
    dev = resolve_device(device)
    pred_list, gt_list, fix_list, img_list, name_list = [], [], [], [], []
    for batch in dataset.iter_batches(batch_size, max_instances):
        preds = _predict(predict_fn, batch, dev, input_cast).float().cpu()
        preds = preds.numpy()
        b, t = preds.shape[:2]
        pred_list.append(preds.reshape(b * t, *preds.shape[2:]))
        gt_list.append(batch["gazemaps"].reshape(
            b * t, *batch["gazemaps"].shape[2:]))
        fix = batch["fixationmaps"]
        if fix.dtype == object:
            # ragged original-scale maps: one object entry per frame
            flat = np.empty(b * t, dtype=object)
            for i, frame in enumerate(f for window in fix for f in window):
                flat[i] = frame
            fix_list.append(flat)
        else:
            fix_list.append(fix.reshape(b * t, *fix.shape[2:]))
        img_list.append(batch["frames"].reshape(
            b * t, *batch["frames"].shape[2:]))
        name_list.extend(_frame_names(batch, t))
    return {
        "pred_gazemaps": np.concatenate(pred_list),
        "gt_gazemaps": np.concatenate(gt_list),
        "fixationmaps": np.concatenate(fix_list),
        "images": np.concatenate(img_list),
        "clipnames": name_list,
    }


def generate_on_device(predict_fn: Callable, dataset: ClipDataset,
                       batch_size: int, max_instances: Optional[int] = 50,
                       input_cast: Optional[torch.dtype] = None,
                       device: Device = None, mesh=None) -> dict:
    """`generate`, but the maps never visit the host: per batch the inputs
    go up once, predict runs on `device`, and the pred / gt / fixation
    stacks stay there (concatenated at the end) for `evaluate` to score in
    place. No frame images (only dumps need them). Needs fixed-scale
    fixation maps: raises `RaggedMapsError` for ragged ones. With a `mesh`
    the stacks are built on this rank's device (`predict_fn` returns the
    whole batch's maps on every rank, as the sharded predict does)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    pred_list, gt_list, fix_list, name_list = [], [], [], []
    for batch in dataset.iter_batches(batch_size, max_instances):
        if batch["fixationmaps"].dtype == object:
            raise RaggedMapsError(
                "generate_on_device needs fixed-scale fixation maps; use "
                "generate() + the NumPy protocol for ragged original-scale "
                "maps")
        preds = _predict(predict_fn, batch, dev, input_cast)
        maps = device_put_batch({k: batch[k] for k in
                                 ("gazemaps", "fixationmaps")}, dev)
        b, t = preds.shape[:2]
        pred_list.append(preds.reshape(b * t, *preds.shape[2:]))
        gt_list.append(maps["gazemaps"].reshape(b * t,
                                                *maps["gazemaps"].shape[2:]))
        fix_list.append(maps["fixationmaps"].reshape(
            b * t, *maps["fixationmaps"].shape[2:]))
        name_list.extend(_frame_names(batch, t))
    return {
        "pred_gazemaps": torch.cat(pred_list),
        "gt_gazemaps": torch.cat(gt_list),
        "fixationmaps": torch.cat(fix_list),
        "clipnames": name_list,
    }


def _is_ragged(fixationmaps) -> bool:
    if isinstance(fixationmaps, torch.Tensor):
        return False  # a tensor is rectangular by construction
    if isinstance(fixationmaps, np.ndarray):
        return fixationmaps.dtype == np.dtype(object)
    return len({np.shape(f) for f in fixationmaps}) > 1


def evaluate(pred_gazemaps, gt_gazemaps, fixationmaps,
             metrics: Sequence[str] = AVAILABLE_METRICS,
             generator: Optional[torch.Generator] = None,
             on_device: bool = True, n_rep: int = 100, exact: bool = True,
             device: Device = None, mesh=None) -> dict:
    """Mean per-frame scores. `on_device=True` runs the batched metrics at
    map scale on the maps' device (tensors) or on `device` (NumPy stacks;
    None = the card), with `generator` (seed 0 when None);
    `on_device=False` runs the NumPy protocol (including the
    original-scale resize when fixation maps are larger), which ragged
    fixation maps fall back to. `exact` selects the closed-form
    AUC_Borji / AUC_shuffled expectation (default) or the reference's
    samplers on the device path; the NumPy protocol always samples.
    `mesh` splits the on-device scoring's frames over its "data" axis
    (exact mode is deterministic: the same scores as one process)."""
    if on_device and _is_ragged(fixationmaps):
        log.warn("fixation maps are ragged (mixed resolutions): falling "
                 "back to the NumPy metric protocol")
        on_device = False
    if on_device and mesh is not None:
        from ..parallel import make_sharded_evaluate

        scores = make_sharded_evaluate(
            mesh, metrics=tuple(metrics), n_rep=n_rep, exact=exact)(
            pred_gazemaps, gt_gazemaps, fixationmaps, generator)
        out = {m: float(np.nanmean(v.cpu().numpy()))
               for m, v in scores.items()}
    elif on_device:
        dev = (pred_gazemaps.device if isinstance(pred_gazemaps, torch.Tensor)
               else resolve_device(device))
        scores = metrics_torch.evaluate_batch(
            torch.as_tensor(pred_gazemaps, device=dev),
            torch.as_tensor(gt_gazemaps, device=dev),
            torch.as_tensor(fixationmaps, device=dev), generator,
            metrics=tuple(metrics), n_rep=n_rep, exact=exact)
        out = {m: float(np.nanmean(v.cpu().numpy()))
               for m, v in scores.items()}
    else:
        rng = np.random.RandomState(0)
        out = {m: metrics_np.saliency_score(m, list(pred_gazemaps),
                                            list(gt_gazemaps),
                                            list(fixationmaps), rng=rng)
               for m in metrics}
    if mesh is None or mesh.rank == 0:
        for metric, score in out.items():
            log.infov("Saliency %s : %f", metric, score)
    return out


def generate_and_evaluate(predict_fn: Callable, dataset: ClipDataset,
                          batch_size: int, max_instances: Optional[int] = 50,
                          metrics: Sequence[str] = AVAILABLE_METRICS,
                          on_device: bool = True,
                          input_cast: Optional[torch.dtype] = None,
                          keep_maps: str = "device",
                          device: Device = None,
                          mesh=None) -> tuple[dict, dict]:
    """`gaze_rnn.py:677-680`. `keep_maps="device"` (default) scores without
    moving the maps to the host (falling back to the host path for ragged
    original-scale maps or `on_device=False`); `keep_maps="host"` returns
    NumPy stacks with the frame images, as the reference's loop does.
    `mesh`: every rank calls alike, `predict_fn` is the sharded predict,
    and the scoring splits over the mesh (`evaluate`)."""
    if mesh is not None:
        device = mesh.device
    if keep_maps == "device" and on_device:
        try:
            ret = generate_on_device(predict_fn, dataset, batch_size,
                                     max_instances, input_cast=input_cast,
                                     device=device, mesh=mesh)
        except RaggedMapsError:
            ret = None
        if ret is not None:
            scores = evaluate(ret["pred_gazemaps"], ret["gt_gazemaps"],
                              ret["fixationmaps"], metrics=metrics,
                              mesh=mesh)
            return ret, scores
    ret = generate(predict_fn, dataset, batch_size, max_instances,
                   input_cast=input_cast, device=device)
    scores = evaluate(ret["pred_gazemaps"], ret["gt_gazemaps"],
                      ret["fixationmaps"], metrics=metrics,
                      on_device=on_device, device=device, mesh=mesh)
    return ret, scores


def write_overall(path: str, scores: dict) -> None:
    """Aggregate score dump (reference `overall.txt`,
    `models/evaluate_gaze.py:216-227`)."""
    with open(path, "w") as f:
        for metric, score in sorted(scores.items()):
            f.write(f"{metric}: {score}\n")
