"""The rank mesh and its layouts: the port's counterpart of the JAX
package's `parallel/mesh.py`.

The JAX package names a device mesh and lets jit partition the program.
Here each rank is a process under `torch.distributed` with one device, and
a `Mesh` holds what that rank needs: the (data, model) sizes, its place in
the grid, the process groups of its two axes and its device. Ranks fill
the grid row-major, as the JAX package reshapes its device list: rank r
sits at (r // model, r % model), so under torchrun (ranks node-major) a
host's ranks are neighbours on the data axis.

  * "data" splits the batch: each rank holds batch / data rows
    (`shard_batch`), gradients are averaged over the data group;
  * "model" splits the wide products' weights `fc1_w`, `fc2_w`,
    `proj_c3d_W` and `proj_out_W` by their last dim when it divides
    (`param_spec`); `ops.layers.linear` gathers their products. Every
    other leaf is replicated.

A layout ("spec") is a tuple naming the axis each dim is split over, the
JAX package's PartitionSpec: `batch_spec()` is ("data",), a split weight
(None, "model"), a replicated one ().
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import ShardingConfig
from ..data.prefetch import device_put_batch
from ..ops.collectives import ModelShard, mark_shard, shard_of
from ..utils import env_world, init_distributed, log, rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

Device = Union[str, torch.device]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a (data, model) grid of ranks. `data_group` /
    `model_group` are the process groups of this rank's column and row of
    the grid (None for an axis of size 1); `device` is this rank's."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    owns_process_group: bool = False  # make_mesh started it

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def close(self) -> None:
        """End the default process group if this mesh's `make_mesh`
        started it (a CLI run leaves none behind)."""
        if self.owns_process_group and dist.is_initialized():
            dist.destroy_process_group()

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank (an all-reduce MAX), the same
        answer on every rank: so every rank leaves its loop at the same
        step (a signal reaches the ranks at different step boundaries),
        or raises together."""
        if self.size == 1:
            return flag
        flag = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def broadcast_object(self, obj):
        """Rank 0's `obj` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """Mesh of shape (data, model) over the job's ranks; data_parallel=-1
    takes every rank left after the model axis. Starts the process group
    from the environment when it is not up (`utils.init_distributed`).

    `devices` gives each rank's device, rank by rank (the JAX package's
    device list): ["cuda:0", "cuda:0"] puts two ranks on one card. None:
    the card LOCAL_RANK picks; ranks that share a card, or sit on the CPU,
    talk over gloo, others over NCCL (`utils.init_distributed`). The mesh
    must cover every rank: one larger than the job raises the JAX
    package's ValueError, before the group starts."""
    rank, world, _ = env_world()
    n = world if devices is None else min(world, len(devices))
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel == -1:  # at least one row: a model axis wider than
        data_parallel = max(n // model_parallel, 1)  # the job raises below
    need = data_parallel * model_parallel
    if need > n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} needs "
                         f"{need} devices, have {n}")
    if need < world:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} covers "
                         f"{need} of the job's {world} ranks; launch "
                         f"{need} processes")
    device = rank_device(None if devices is None else devices[rank])
    shared = devices is not None and len(
        {str(torch.device(d)) for d in devices[:need]}) < need
    started = init_distributed(device, shared)
    data_group = model_group = None
    # every rank creates every group, in one order
    for i in range(data_parallel):
        ranks = [i * model_parallel + j for j in range(model_parallel)]
        group = dist.new_group(ranks) if model_parallel > 1 else None
        if rank in ranks:
            model_group = group
    for j in range(model_parallel):
        ranks = [i * model_parallel + j for i in range(data_parallel)]
        group = dist.new_group(ranks) if data_parallel > 1 else None
        if rank in ranks:
            data_group = group
    return Mesh(data_parallel, model_parallel, rank, device, data_group,
                model_group, started)


_CLI_MESHES: list = []


def cli_mesh(data_parallel: int, model_parallel: int,
             device: Device = "cuda") -> Mesh:
    """The mesh of a CLI run: the job's ranks from torchrun's environment,
    each on the card LOCAL_RANK picks, or all on the CPU when `device` is
    the CPU. A mesh larger than the job raises (`make_mesh`). The ranks
    but the first log errors only. The CLI ends it with
    `close_cli_meshes`."""
    devices = None  # each rank on the card LOCAL_RANK picks
    if torch.device(device).type == "cpu":
        devices = ["cpu"] * env_world()[1]
    mesh = make_mesh(data_parallel, model_parallel, devices)
    if mesh.rank == 0:
        log.infov("mesh: %s over %d ranks (%s)", mesh.shape, mesh.size,
                  dist.get_backend())
    else:
        log.errors_only()
    _CLI_MESHES.append(mesh)
    return mesh


def close_cli_meshes() -> None:
    """Close the meshes `cli_mesh` made (`Mesh.close`): a CLI's main
    leaves no process group behind that it started."""
    while _CLI_MESHES:
        _CLI_MESHES.pop().close()


def mesh_from_config(cfg: ShardingConfig,
                     devices: Optional[Sequence[Device]] = None) -> Mesh:
    return make_mesh(cfg.data_parallel, cfg.model_parallel, devices)


def make_hybrid_mesh(dcn_data_parallel: int, ici_data_parallel: int = -1,
                     model_parallel: int = 1,
                     devices: Optional[Sequence[Device]] = None) -> Mesh:
    """Multi-host mesh: the data axis is (hosts, ranks per host) with the
    hosts outermost, so a gradient all-reduce is mostly within hosts.
    torchrun numbers ranks host by host, so the row-major grid already has
    this order once each host holds whole model groups; this checks that
    the layout matches LOCAL_WORLD_SIZE. Falls back to a flat mesh when
    the job has one host (or no LOCAL_WORLD_SIZE). `devices`: as in
    `make_mesh`."""
    _, world, _ = env_world()
    model_parallel = max(model_parallel, 1)
    if ici_data_parallel == -1:
        ici_data_parallel = world // max(dcn_data_parallel, 1) \
            // model_parallel
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(world // max(local_world, 1), 1)
    if hosts > 1:
        if dcn_data_parallel != hosts or \
                ici_data_parallel * model_parallel != local_world:
            raise ValueError(
                f"hybrid mesh {dcn_data_parallel}x{ici_data_parallel}x"
                f"{model_parallel} does not match the job's {hosts} hosts "
                f"of {local_world} ranks")
    return make_mesh(dcn_data_parallel * ici_data_parallel, model_parallel,
                     devices)


def batch_spec() -> tuple:
    """Batch arrays: split on the leading (batch) dim over "data"."""
    return (DATA_AXIS,)


# ----------------------------------------------------------------- batches

_SHARD_OF_MESH = "_rgp_batch_shard_of"


def _is_rank_shard(value, mesh: Mesh) -> bool:
    return getattr(value, _SHARD_OF_MESH, None) is mesh


def _mark_rank_shard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    setattr(t, _SHARD_OF_MESH, mesh)
    return t


def rank_rows(b: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of `b` rows."""
    if b % mesh.data:
        raise ValueError(f"a batch of {b} rows does not split over the "
                         f"data axis ({mesh.data})")
    k = b // mesh.data
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def shard_batch(batch: dict, mesh: Mesh,
                cast: Optional[dict] = None) -> dict:
    """This rank's rows of a global batch, on this rank's device. Clip
    names and ragged object arrays are dropped. Host arrays are sliced on
    the host, so only this rank's rows are copied (cast per `cast` first,
    as `data.prefetch.device_put_batch` does). A tensor that is already
    this rank's shard (an output of this function, e.g. from the prefetch
    thread) passes through as the same object; any other tensor is taken
    as the global batch and sliced, device to device."""
    out, host = {}, {}
    for key, value in batch.items():
        if key == "clipnames" or getattr(value, "dtype", None) == np.dtype(
                object):
            continue
        if _is_rank_shard(value, mesh):
            out[key] = value
        elif isinstance(value, torch.Tensor):
            rows = value[rank_rows(value.shape[0], mesh)]
            dtype = cast.get(key, rows.dtype) if cast else rows.dtype
            out[key] = _mark_rank_shard(
                rows.to(mesh.device, dtype).contiguous(), mesh)
        else:
            value = np.asarray(value)
            host[key] = value[rank_rows(value.shape[0], mesh)]
    for key, t in device_put_batch(host, mesh.device, cast).items():
        out[key] = _mark_rank_shard(t, mesh)
    return out


def host_local_slice(global_batch: int,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> slice:
    """The rows of a global batch this process loads. Defaults: this
    rank of the job's ranks; with a model axis pass the mesh's data rank
    and data size (the ranks of one model group load the same rows)."""
    rank, world, _ = env_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pc} processes")
    per_host = global_batch // pc
    return slice(pi * per_host, (pi + 1) * per_host)


def global_batch_from_host_local(batch: dict, mesh: Mesh) -> dict:
    """Host-local rows (`host_local_slice`) as this rank's shard of the
    global batch, on this rank's device: the tensors pass through
    `shard_batch` and the steps as they are."""
    host = {k: v for k, v in batch.items() if k != "clipnames"}
    return {k: _mark_rank_shard(t, mesh) for k, t in
            device_put_batch({k: np.asarray(v) for k, v in host.items()},
                             mesh.device).items()}


# --------------------------------------------------------------- parameters

# The wide products worth splitting over the model axis: the ShallowNet FC
# stack (3872x4802, 2401x4802), the C3D 1024->P projection and the output
# projections / cascade FC heads.
_MODEL_SHARDED_LEAVES = ("fc1_w", "fc2_w", "proj_c3d_W", "proj_out_W")


def param_spec(name: str, leaf: Any, model_parallel: bool,
               model_axis_size: int = 2) -> tuple:
    """The layout of one parameter (named as the port names it, the leaf
    name last: "c3d_proj.proj_c3d_W"): the last dim of a wide product's
    weight over "model" when the ACTUAL model size divides it; everything
    else replicated."""
    shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
    shard = shard_of(leaf)
    if shard is not None:  # a column slice: its whole width's layout
        shape = shape[:-1] + (shard.full,)
    if not model_parallel:
        return ()
    if name.split(".")[-1] in _MODEL_SHARDED_LEAVES and len(shape) >= 2:
        if shape[-1] % model_axis_size == 0:
            return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def params_shardings(params: dict, mesh: Mesh,
                     model_parallel: Optional[bool] = None) -> dict:
    """{name: layout} for a dict of parameters (`param_spec`)."""
    if model_parallel is None:
        model_parallel = mesh.model > 1
    return {name: param_spec(name, leaf, model_parallel, mesh.model)
            for name, leaf in params.items()}


def _place(tensors: dict, name: str, t: torch.Tensor) -> torch.Tensor:
    """Put `t` under `name` in `tensors`: a Parameter keeps its identity
    (the model holds it), its data replaced."""
    old = tensors[name]
    if isinstance(old, nn.Parameter):
        old.data = t
        return old
    tensors[name] = t
    return t


@torch.no_grad()
def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of `tree` (a dict, or a tuple / list of dicts) moved to
    this rank's device and broadcast from rank 0, in place; returns it. A
    column slice (`shard_params`) is this rank's own and is left as it
    is."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(t, mesh) for t in tree)
    for name, t in list(tree.items()):
        if not isinstance(t, torch.Tensor) or shard_of(t) is not None:
            continue
        moved = t.data.to(mesh.device) if isinstance(t, nn.Parameter) \
            else t.to(mesh.device)
        if mesh.size > 1:
            moved = moved.contiguous()
            dist.broadcast(moved, src=0)
        _place(tree, name, moved)
    return tree


_PLACED_ON = "_rgp_placed_on"


def place_params(params: dict, mesh: Mesh,
                 model_parallel: Optional[bool] = None) -> dict:
    """`replicate`, then `shard_params`, unless every parameter already
    sits on this mesh (a model's parameters are placed once, whichever of
    the mesh's steps meets them first)."""
    if all(getattr(p, _PLACED_ON, None) is mesh for p in params.values()):
        return params
    replicate(params, mesh)
    shard_params(params, mesh, model_parallel)
    for p in params.values():
        setattr(p, _PLACED_ON, mesh)
    return params


@torch.no_grad()
def shard_params(params: dict, mesh: Mesh,
                 model_parallel: Optional[bool] = None) -> dict:
    """Place a dict of whole parameters per `params_shardings`, in place:
    each on this rank's device, a split one cut to this rank's columns
    and marked with its `ModelShard`. Returns the dict."""
    specs = params_shardings(params, mesh, model_parallel)
    for name, t in list(params.items()):
        data = t.data if isinstance(t, nn.Parameter) else t
        data = data.to(mesh.device)
        if MODEL_AXIS in specs[name] and shard_of(t) is None:
            shard = ModelShard(mesh.model_group, mesh.model_rank, mesh.model,
                               data.shape[-1])
            data = data[..., shard.columns()].contiguous()
            mark_shard(_place(params, name, data), shard)
        else:
            _place(params, name, data)
    return params
