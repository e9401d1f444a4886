"""Device selection and process-group start-up for the port's entry points.

Every entry point takes a `device`; None means the card. Nothing moves to
the CPU unless the caller asks for it (the CPU tests pass "cpu").

A multi-rank job is one process per rank under `torch.distributed`,
started by `torchrun` (`python -m torch.distributed.run`), which sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. A process
started without them is a world of one.
"""

from __future__ import annotations

import contextlib
import os
import signal
import socket
import subprocess
import time
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> "cuda". Raises RuntimeError when CUDA is asked for (or
    implied) on a host without it, instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN and matmuls (process-wide flags, restored on
    exit), so f32 work on the card is f32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def env_world() -> tuple[int, int, int]:
    """(rank, world size, local rank): from the default process group when
    it is up, else from torchrun's environment, else (0, 1, 0)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)), local)


def rank_device(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """This rank's device: `device` when given, else the card LOCAL_RANK
    picks. Raises when that card does not exist: two ranks are never put
    on one card unless the caller names it for both."""
    if device is not None:
        return resolve_device(device)
    local = env_world()[2]
    dev = resolve_device(f"cuda:{local}")
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} needs card cuda:{local}, but this host "
            f"has {torch.cuda.device_count()}; launch at most that many "
            f"ranks per host")
    return dev


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device: torch.device, shared: bool) -> bool:
    """Start the default process group unless it is up; returns whether
    this call started it. The backend: gloo when the ranks are on the CPU
    or `shared` (some ranks share a card: NCCL refuses two ranks on one
    device), else NCCL, which raises without a card. The group comes from
    torchrun's environment; a process without WORLD_SIZE is a world of
    one, on a free localhost port."""
    if dist.is_initialized():
        return False
    backend = "gloo" if device.type == "cpu" or shared else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA card, and "
                           "torch.cuda.is_available() is False; run on "
                           "the CPU over gloo (device='cpu')")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            rank=0, world_size=1)
    return True


def rank_envs(world: int, env: Optional[dict] = None) -> list[dict]:
    """The environments of `world` local ranks, as torchrun sets them
    (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT on a free localhost port), over `env` (default: this
    process's)."""
    base = dict(os.environ if env is None else env,
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    return [dict(base, RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)]


def run_processes(cmds: list, envs: list, timeout: float) -> list:
    """Run the commands at once, each in a process group of its own, and
    wait for all; past `timeout` seconds in all, or on any exception, the
    whole groups are killed (a launcher's workers too), so no process
    outlives the call. Returns [(returncode, stdout + stderr)]; a command
    killed at the deadline has a negative return code."""
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for cmd, env in zip(cmds, envs)]
    deadline = time.monotonic() + timeout
    out = []
    try:
        for proc in procs:
            try:
                log = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0]
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                log = proc.communicate()[0]
            out.append((proc.returncode, log))
    finally:
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    return out
