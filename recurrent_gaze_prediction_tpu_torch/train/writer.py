"""Metric writer: the port's copy of the JAX package's `train/writer.py`.

Scalars always go to `{train_dir}/metrics.jsonl`, one record per call in
the JAX package's format (`{"step", "time", <name>: value, ...}`);
TensorBoard event files are written too when `torch.utils.tensorboard`
imports. Image summaries are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import time

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

    def __call__(self, step: int, values: dict) -> None:
        self.scalars(step, values)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
