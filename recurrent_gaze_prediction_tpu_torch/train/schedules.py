"""Learning-rate schedules: the port's copy of the JAX package's
`train/schedules.py`.

The reference uses `tf.train.exponential_decay(lr, global_step,
decay_steps=500, decay_rate=0.80, staircase=True)` (its
`models/gaze_rnn.py:436-444`). Schedules here are pure functions of the
step, so resume is always correct (the reference reset a Variable LR on
restore, `models/base.py:221-231`). They return python floats; the
optimizer computes them in float32, as the JAX schedules do.
"""

from __future__ import annotations

import numpy as np


def exponential_decay(initial_learning_rate: float, decay_rate: float,
                      decay_steps: int, staircase: bool = True):
    def schedule(step) -> float:
        p = np.float32(step) / np.float32(decay_steps)
        if staircase:
            p = np.floor(p)
        return float(np.float32(initial_learning_rate)
                     * np.power(np.float32(decay_rate), p))

    return schedule


def constant(initial_learning_rate: float):
    def schedule(step) -> float:
        del step
        return float(np.float32(initial_learning_rate))

    return schedule
