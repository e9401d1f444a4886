"""Metric writer: the port's copy of the JAX package's `train/writer.py`.

Scalars always go to `{train_dir}/metrics.jsonl`, one record per call in
the JAX package's format (`{"step", "time", <name>: value, ...}`);
TensorBoard event files are written too when `torch.utils.tensorboard`
imports, and with them the image summaries of the validation steps
(input frame, gt map, predicted map; the reference's
`models/gaze_rnn.py:172-208`).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..utils import log


class MetricWriter:
    def __init__(self, train_dir: str):
        self.train_dir = train_dir
        os.makedirs(train_dir, exist_ok=True)
        self._jsonl = open(os.path.join(train_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=train_dir)
        except Exception as e:  # tensorboard is optional
            log.warn("tensorboard writer unavailable: %s", e)

    def scalars(self, step: int, values: dict) -> None:
        record = {"step": int(step), "time": time.time(),
                  **{k: float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for key, value in values.items():
                self._tb.add_scalar(key, float(value), int(step))

    def images(self, step: int, tag: str, maps: np.ndarray,
               max_outputs: int = 2) -> None:
        """[N, H, W] or [N, H, W, C] image summaries, each min-max
        normalized (reference `_add_image_summary`, max_outputs=2,
        `gaze_rnn.py:172-173`); TensorBoard only."""
        if self._tb is None:
            return
        for i, img in enumerate(np.asarray(maps, np.float32)[:max_outputs]):
            img = img[None] if img.ndim == 2 else np.transpose(img, (2, 0, 1))
            lo, hi = img.min(), img.max()
            if hi > lo:
                img = (img - lo) / (hi - lo)
            self._tb.add_image(f"{tag}/{i}", img, int(step))

    def __call__(self, step: int, values: dict) -> None:
        self.scalars(step, values)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
