from .logging import log, mkdir_p
from .platform import (env_world, free_port, init_distributed, rank_device,
                       rank_envs, resolve_device, run_processes, tf32_off)
from .tree import cast_floating, describe, param_bytes, param_count

__all__ = ["log", "mkdir_p", "resolve_device", "tf32_off", "env_world",
           "rank_device", "init_distributed", "free_port", "rank_envs",
           "run_processes", "param_count",
           "param_bytes", "cast_floating", "describe"]
