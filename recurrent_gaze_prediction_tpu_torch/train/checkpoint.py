"""Checkpoints of the TrainState: the port's counterpart of the JAX
package's `train/checkpoint.py`, with its layout.

  * `{train_dir}/model/<step>/state.pt` per saved step, the newest
    `max_to_keep` kept, and `{train_dir}/config.json` beside them
    (reference layout: checkpoints in `{train_dir}/model/`,
    `models/base.py:240-253`);
  * a checkpoint holds {params, opt_state, step} explicitly, so resume is
    exact, including the LR schedule position; a fused run's state
    (`train/fused.FusedTrainState`) adds the C3D tower's weights
    (`c3d_params`) and, when the tower is fine-tuned, its optimizer state
    (`opt_state` is a list of one or two). Params and moments are stored
    under the JAX package's flat names ("cell/W_z"), on the CPU, with
    `torch.save`.

  * `save_params` / `load_params`: a params-only file (a pretrained
    ShallowNet, `cli.pretrain_shallownet`) in the port's own format, a
    `torch.save` of {flat JAX name: CPU tensor};
  * `restore_shallownet` grafts such a file's ShallowNet into a gaze
    model's `shallownet.*` parameters, the counterpart of the reference's
    per-variable assign surgery (`models/gaze_rnn.py:412-433`).

Under a mesh (`parallel.make_mesh`) every rank calls `save` and
`restore`: a weight split over the model axis is gathered whole, rank 0
alone writes the same `state.pt`, and every rank restores the whole
tensors and takes its own columns, so a checkpoint moves between
topologies both ways. Rank 0 decides for every rank whether a step is
already saved and which step `restore_latest` takes, so the ranks run
the same collectives; the ranks read what rank 0 wrote, so `train_dir`
must be on a filesystem they all see, and a rank that cannot see rank
0's step makes every rank raise.

The port reads no orbax checkpoint of the JAX package (it imports
neither orbax nor jax, and the card's machine has no jax):
`scripts/convert_jax_checkpoint.py`, run where jax is, turns a JAX run
into this layout and a JAX `save_params` file into this one's. Weights
also cross between the packages through bundles (`serving/bundle.py`)
and `bridge.py`.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ..bridge import jax_name
from ..config import ExperimentConfig
from ..ops.collectives import local_columns, whole_tensor
from ..utils import log
from .state import TrainState

_FILE = "state.pt"


def _by_jax_name(tensors: dict) -> dict:
    return {jax_name(n): whole_tensor(t).detach().cpu()
            for n, t in tensors.items()}


def _opt_states(state: TrainState) -> tuple:
    """The state's optimizer states: one, or the pair (gaze, C3D) of a
    fine-tuned fused run."""
    opt = state.opt_state
    return tuple(opt) if isinstance(opt, (tuple, list)) else (opt,)


def _saved_opt(opt: dict) -> dict:
    return {k: (_by_jax_name(v) if isinstance(v, dict) else v)
            for k, v in opt.items()}


class Checkpointer:
    """Save/restore a TrainState under `{train_dir}/model/<step>` with
    retention, plus config.json beside it. With a `mesh`, every rank makes
    one and calls its methods alike; rank 0 alone writes."""

    def __init__(self, train_dir: str, max_to_keep: int = 3, mesh=None):
        self.train_dir = os.path.abspath(train_dir)
        self.model_dir = os.path.join(self.train_dir, "model")
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            os.makedirs(self.model_dir, exist_ok=True)
        self._barrier()

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _rank0s(self, decide):
        """Rank 0's `decide()` on every rank (the other ranks do not call
        it): their filesystems may lag rank 0's writes, or not be its."""
        if self.mesh is None:
            return decide()
        return self.mesh.broadcast_object(decide() if self.writer else None)

    def steps(self) -> list[int]:
        if not os.path.isdir(self.model_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.model_dir)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.model_dir, d, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> None:
        """Write the state at its step (once per step), then drop all but
        the newest `max_to_keep` checkpoints."""
        path = os.path.join(self.model_dir, str(state.step))
        if self._rank0s(lambda: os.path.exists(os.path.join(path, _FILE))):
            return
        saved = {"step": state.step, "params": _by_jax_name(state.params),
                 "opt_state": [_saved_opt(o) for o in _opt_states(state)]}
        c3d = getattr(state, "c3d_params", None)
        if c3d is not None:
            saved["c3d_params"] = _by_jax_name(c3d)
        if self.writer:
            self._write(path, saved, state.step)
        self._barrier()  # no rank reads a checkpoint before it is whole

    def _write(self, path: str, saved: dict, step: int) -> None:
        tmp = f"{path}.tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(saved, os.path.join(tmp, _FILE))
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.model_dir, str(old)))
        log.info(" [Checkpoint] saved step %d -> %s", step, self.model_dir)

    def restore(self, step: int, state: TrainState) -> TrainState:
        """Load checkpoint `step` into `state` (in place: the model's
        parameters, the moments, the step) and return it. A tensor of the
        state that is a column slice takes its columns of the whole."""
        path = os.path.join(self.model_dir, str(step), _FILE)
        seen = os.path.exists(path)
        if self.mesh is not None and self.mesh.any_rank(not seen):
            raise FileNotFoundError(
                f"checkpoint {path} is missing on some rank of the mesh "
                f"(rank {self.mesh.rank} "
                f"{'sees' if seen else 'does not see'} it); "
                f"the ranks read what rank 0 writes, so train_dir must be "
                f"on a filesystem they all see")
        saved = torch.load(path, map_location="cpu", weights_only=True)

        def copy_into(dst: dict, src: dict, what: str) -> None:
            want = {jax_name(n) for n in dst}
            if set(src) != want:
                raise ValueError(f"checkpoint {path} {what} do not match: "
                                 f"missing {sorted(want - set(src))}, "
                                 f"unexpected {sorted(set(src) - want)}")
            with torch.no_grad():
                for n, t in dst.items():
                    t.copy_(local_columns(src[jax_name(n)], t))

        copy_into(state.params, saved["params"], "params")
        c3d = getattr(state, "c3d_params", None)
        if (c3d is None) != ("c3d_params" not in saved):
            raise ValueError(f"checkpoint {path}: a C3D tower in only one of "
                             f"the checkpoint and the state")
        if c3d is not None:
            copy_into(c3d, saved["c3d_params"], "c3d_params")
        opts = _opt_states(state)
        stored_opts = saved["opt_state"]
        if isinstance(stored_opts, dict):  # written before fused runs
            stored_opts = [stored_opts]
        if len(opts) != len(stored_opts):
            raise ValueError(f"checkpoint {path} holds {len(stored_opts)} "
                             f"optimizer states, the state {len(opts)}")
        for i, (opt, stored) in enumerate(zip(opts, stored_opts)):
            for key, value in stored.items():
                if isinstance(value, dict):
                    copy_into(opt[key], value, f"opt_state[{i}][{key}]")
                else:
                    opt[key] = value
        state.step = int(saved["step"])
        if self.writer:
            log.info(" [Checkpoint] restored step %d from %s", step,
                     self.model_dir)
        return state

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        """`restore` of the newest step (rank 0's, under a mesh), or None
        when there is none."""
        step = self._rank0s(self.latest_step)
        return None if step is None else self.restore(step, state)

    def save_config(self, cfg: ExperimentConfig) -> None:
        if not self.writer:
            return
        config_file = os.path.join(self.train_dir, "config.json")
        if os.path.exists(config_file):
            log.warn("config_file %s already exists (skipped)", config_file)
            return
        cfg.dump(config_file)

    @staticmethod
    def load_config(train_dir: str) -> ExperimentConfig:
        return ExperimentConfig.load(os.path.join(train_dir, "config.json"))


_PARAMS_FORMAT = "rgp_torch_params/1"


def save_params(path: str, params: dict) -> None:
    """Write a params-only file: {flat JAX name ("conv1_w", "cell/W_z"):
    tensor} on the CPU. Refuses an existing path (as the JAX package's
    orbax writer does), before anything is written."""
    if os.path.exists(path):
        raise FileExistsError(f"{path} already exists; remove it or pick a "
                              f"fresh path")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"format": _PARAMS_FORMAT, "params": _by_jax_name(params)},
               tmp)
    os.replace(tmp, path)


def load_params(path: str) -> dict:
    """The {flat JAX name: CPU tensor} dict of a `save_params` file."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(saved, dict) or saved.get("format") != _PARAMS_FORMAT:
        raise ValueError(f"{path} is not a params file of this package "
                         f"(save_params); the JAX package's orbax "
                         f"checkpoints need converting first")
    return saved["params"]


def restore_shallownet(model, path: str):
    """Graft a pretrained ShallowNet (a `save_params` file of its params,
    as `cli.pretrain_shallownet` writes) into `model`'s `shallownet.*`
    parameters, in place; returns the model. Only the ShallowNet is
    touched: the optimizer's moments are never read or written here."""
    if not hasattr(model, "shallownet"):
        raise ValueError(f"model {model.cfg.name} has no 'shallownet' "
                         f"subtree")
    loaded = load_params(path)
    target = model.shallownet
    want = set(target.keys())
    if set(loaded) != want:
        raise ValueError(f"{path}: ShallowNet params do not match: missing "
                         f"{sorted(want - set(loaded))}, unexpected "
                         f"{sorted(set(loaded) - want)}")
    with torch.no_grad():
        for name, p in target.items():
            if tuple(loaded[name].shape) != tuple(p.shape):
                raise ValueError(f"{path}: {name} has shape "
                                 f"{tuple(loaded[name].shape)}, the model "
                                 f"{tuple(p.shape)}")
            p.copy_(loaded[name])
    log.info("Loaded pretrained ShallowNet from %s", path)
    return model
