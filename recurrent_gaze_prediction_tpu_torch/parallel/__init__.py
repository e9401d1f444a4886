"""Multi-rank training, inference and scoring over `torch.distributed`:
the port's counterpart of the JAX package's `parallel/` (mesh layouts,
data- and model-parallel steps, window-sharded raw video)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_spec,
    global_batch_from_host_local,
    host_local_slice,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_config,
    params_shardings,
    replicate,
    shard_batch,
    shard_params,
)
from .sharding import (
    make_sharded_evaluate,
    make_sharded_fused_predict,
    make_sharded_fused_train_step,
    make_sharded_predict,
    make_sharded_stream_fn,
    make_sharded_train_step,
    place_state,
    state_shardings,
)
from .temporal import (
    make_temporal_sharded_extract,
    make_temporal_sharded_fused_predict,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "make_hybrid_mesh",
    "mesh_from_config",
    "batch_spec",
    "shard_batch",
    "shard_params",
    "params_shardings",
    "replicate",
    "place_state",
    "state_shardings",
    "make_sharded_train_step",
    "make_sharded_predict",
    "host_local_slice",
    "global_batch_from_host_local",
    "make_sharded_stream_fn",
    "make_sharded_evaluate",
    "make_sharded_fused_predict",
    "make_sharded_fused_train_step",
    "make_temporal_sharded_extract",
    "make_temporal_sharded_fused_predict",
]
