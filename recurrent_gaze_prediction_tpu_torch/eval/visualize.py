"""Visualization: the port's counterpart of the JAX package's
`eval/visualize.py` (the reference's `evaluation/visualize_output.py` and
`evaluation/imagetools.py`).

  * `imshow_grid` / `save_grid`: tile a stack of maps into one grid image
    (`visualize_output.py:22-51`), NumPy + PIL;
  * `visualize_outputs`: resurrect a run (config.json + latest
    checkpoint), predict and dump frame / gt / pred grids
    (`visualize_output.py:87-150`);
  * `encode_salicon_result` / `save_salicon_json` /
    `decode_salicon_result`: SALICON-format base64-PNG result records
    (`imagetools.py:15-71`).

PIL is imported only where an image is written or read.
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..data import crc as crc_data
from ..data import synthetic
from ..registry import create_model
from ..train import Checkpointer, create_train_state, make_predict_fn
from ..utils import log, mkdir_p, resolve_device
from . import evaluator


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    # constant tiles skip normalization; clip so a constant value > 1
    # does not WRAP modulo 256 in the uint8 cast
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def imshow_grid(maps: np.ndarray, ncols: int = 8,
                pad: int = 1) -> np.ndarray:
    """[N, H, W] (or [N, H, W, 3]) -> one tiled uint8 grid image."""
    maps = np.asarray(maps)
    n = len(maps)
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    h, w = maps.shape[1:3]
    channels = maps.shape[3] if maps.ndim == 4 else 1
    grid = np.zeros((nrows * (h + pad) - pad, ncols * (w + pad) - pad,
                     channels), np.uint8)
    for i, m in enumerate(maps):
        r, c = divmod(i, ncols)
        tile = _to_uint8(m)
        if tile.ndim == 2:
            tile = tile[:, :, None]
        grid[r * (h + pad):r * (h + pad) + h,
             c * (w + pad):c * (w + pad) + w] = tile
    return grid.squeeze()


def save_grid(path: str, maps: np.ndarray, ncols: int = 8) -> None:
    from PIL import Image

    Image.fromarray(imshow_grid(maps, ncols)).save(path)


def visualize_outputs(train_dir: str, out_dir: Optional[str] = None,
                      max_instances: int = 8,
                      data_root: Optional[str] = None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> dict:
    """Resurrect a run (config.json + latest checkpoint) on `device` (None
    = the card), predict its validation clips and write frames.png,
    gt.png and pred.png grids under `out_dir` (default
    `{train_dir}/visualization`). A run on a real dataset reads its valid
    split under `data_root`, as the CLIs do; without one it is shown on
    synthetic clips, with a warning (the reference resurrects the real
    split, `visualize_output.py:98-150`)."""
    dev = resolve_device(device)
    exp = Checkpointer.load_config(train_dir)
    model = create_model(exp.model.name, exp.model, device=dev)
    state, _ = create_train_state(model, exp.optimizer)
    Checkpointer(train_dir).restore_latest(state)

    cfg = model.cfg
    gh, gw = cfg.gazemap_height, cfg.gazemap_width
    if exp.dataset != "synthetic" and data_root:
        dataset = crc_data.read_crc_data_sets(
            cfg.image_height, cfg.image_width, gh, gw, dataset=exp.dataset,
            layouts=crc_data.layouts_for(exp.dataset, data_root),
            split_modes="valid", seq_len=cfg.n_lstm_steps, use_cache=False,
            max_folders=max(max_instances, cfg.batch_size)).valid
    else:
        if exp.dataset != "synthetic":
            log.warn("run trained on %s but no data_root given: grids show "
                     "inference on SYNTHETIC clips", exp.dataset)
        dataset = synthetic.make_splits(
            n_train=2, n_valid=max(max_instances, cfg.batch_size), n_test=2,
            t=cfg.n_lstm_steps, gazemap_hw=(gh, gw), seed=exp.seed).valid
    ret = evaluator.generate(make_predict_fn(model), dataset, cfg.batch_size,
                             max_instances, device=dev)

    out_dir = out_dir or os.path.join(train_dir, "visualization")
    mkdir_p(out_dir)
    n = min(32, len(ret["pred_gazemaps"]))
    save_grid(os.path.join(out_dir, "frames.png"), ret["images"][:n])
    save_grid(os.path.join(out_dir, "gt.png"), ret["gt_gazemaps"][:n])
    save_grid(os.path.join(out_dir, "pred.png"), ret["pred_gazemaps"][:n])
    log.infov("wrote visualization grids to %s", out_dir)
    return ret


# ------------------------------------------------------- salicon results

def encode_salicon_result(image_id, saliency_map: np.ndarray) -> dict:
    """One SALICON submission record: a base64-encoded PNG of the map
    (`imagetools.py:15-71`)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_to_uint8(saliency_map)).save(buf, format="PNG")
    return {
        "image_id": image_id,
        "saliency_map": base64.b64encode(buf.getvalue()).decode("ascii"),
    }


def save_salicon_json(path: str, image_ids: Sequence,
                      saliency_maps: np.ndarray) -> None:
    records = [encode_salicon_result(i, m)
               for i, m in zip(image_ids, saliency_maps)]
    with open(path, "w") as f:
        json.dump(records, f)


def decode_salicon_result(record: dict) -> np.ndarray:
    from PIL import Image

    raw = base64.b64decode(record["saliency_map"])
    return np.asarray(Image.open(io.BytesIO(raw)))
