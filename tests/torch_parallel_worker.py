"""One rank of the port's multi-rank CPU tests (`test_torch_parallel.py`,
`test_torch_temporal.py`): a gloo process on 127.0.0.1.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py WORKDIR SCENARIO [...]

Reads WORKDIR/inputs.pt (the test's inputs, keyed by scenario), runs each
scenario over a mesh of all ranks (data x model as WORKDIR/inputs.pt's
"mesh" gives, on its "devices", by default the CPU) and writes WORKDIR/<scenario>.rank<r>.pt: the scenario's
results, or {"error": traceback}. A scenario that fails on every rank
leaves the next one runnable; one that fails on some ranks only ends in a
collective's timeout. Imports no JAX.
"""

import copy
import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from recurrent_gaze_prediction_tpu_torch import registry  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.bridge import (  # noqa: E402
    c3d_params_from_jax, c3d_params_to_jax, jax_name, params_from_jax)
from recurrent_gaze_prediction_tpu_torch.config import (  # noqa: E402
    OptimizerConfig)
from recurrent_gaze_prediction_tpu_torch.data import (  # noqa: E402
    synthetic)
from recurrent_gaze_prediction_tpu_torch.models import (  # noqa: E402
    pipeline)
from recurrent_gaze_prediction_tpu_torch.ops.collectives import (  # noqa
    all_gather_cat, whole_tensor)
from recurrent_gaze_prediction_tpu_torch import parallel  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.train import (  # noqa: E402
    Checkpointer, FusedTrainState, create_train_state, fit)
from recurrent_gaze_prediction_tpu_torch.utils import (  # noqa: E402
    rank_envs, run_processes)


def model_of(spec: dict):
    """A port model on the CPU with the JAX weights `spec["params"]` (or
    the port's state dict `spec["state"]`); the mesh's steps move it to
    each rank's device."""
    model = registry.create_model(spec["name"], device="cpu",
                                  **spec["widths"])
    model.load_state_dict(spec["state"] if "state" in spec
                          else params_from_jax(spec["params"]))
    return model


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def whole_params(params: dict) -> dict:
    return {jax_name(n): host(whole_tensor(p)) for n, p in params.items()}


def train(spec, mesh):
    """Sharded train steps: per-step loss and grad_norm, and the whole
    params after each step."""
    model = model_of(spec)
    state, tx = create_train_state(model, OptimizerConfig(**spec["opt"]))
    step = parallel.make_sharded_train_step(model, tx, mesh, use_flip=False)
    out = {"loss": [], "grad_norm": [], "params": []}
    for batch in spec["batches"]:
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["params"].append(whole_params(state.params))
    return out


def shard_batch(spec, mesh):
    batch = parallel.shard_batch({"x": np.arange(32.).reshape(8, 4),
                                  "clipnames": ["a"] * 8}, mesh)
    again = parallel.shard_batch(batch, mesh)
    whole = torch.arange(32.).reshape(8, 4)
    sliced = parallel.shard_batch({"x": whole}, mesh)
    mine = {"w": torch.full((3,), float(mesh.rank))}
    return {"same_object": again["x"] is batch["x"],
            "keys": sorted(batch), "rows": batch["x"].numpy(),
            "sliced": sliced["x"].numpy(),
            "passes_sliced": parallel.shard_batch(sliced, mesh)["x"]
            is sliced["x"],
            "replicated": parallel.replicate(mine, mesh)["w"].numpy()}


def predict(spec, mesh):
    """A global tail batch, then the first 4 rows loaded host-locally
    (`host_local_slice` + `global_batch_from_host_local`)."""
    model = model_of(spec)
    fn = parallel.make_sharded_predict(model, mesh)
    rows = parallel.host_local_slice(4)
    local = parallel.global_batch_from_host_local(
        {k: spec[k][:4][rows] for k in ("frames", "c3d")
         if spec[k] is not None}, mesh)  # gaze_grcn reads no frames
    return {"maps": host(fn(spec["frames"], spec["c3d"])),
            "host_local": host(fn(local.get("frames"), local["c3d"]))}


def stream(spec, mesh):
    """Chunks of a batch of streams; the state stays a rank's shard."""
    model = model_of(spec)
    step = parallel.make_sharded_stream_fn(model.cfg, mesh)
    feats = spec["feats"]
    b, u = feats.shape[0], model.cfg.rnn_state_size
    state = torch.zeros(b, 7, 7, u)
    chunks = []
    for start in range(0, feats.shape[1], spec["chunk"]):
        state, maps = step(model, state,
                           feats[:, start:start + spec["chunk"]])
        chunks.append(all_gather_cat(maps, mesh.data_group, 0))
    return {"maps": torch.cat(chunks, 1).numpy(),
            "local_state_rows": state.shape[0]}


def fused_predict(spec, mesh):
    model = model_of(spec)
    fn = parallel.make_sharded_fused_predict(model, mesh,
                                             compute_dtype=torch.float32)
    return {"maps": fn(c3d_params_from_jax(spec["c3d"]),
                       spec["video"]).numpy()}


def fused_train(spec, mesh):
    model = model_of(spec)
    state, tx = create_train_state(model, OptimizerConfig(**spec["opt"]))
    c3d = c3d_params_from_jax(spec["c3d"])
    finetune = spec["finetune"]
    state = FusedTrainState(
        params=state.params, c3d_params=c3d,
        opt_state=pipeline.init_fused_opt_state(
            tx, state.params, c3d, finetune_c3d=finetune))
    before = {k: v.clone() for k, v in c3d.items()}
    step = parallel.make_sharded_fused_train_step(
        model, tx, mesh, finetune_c3d=finetune, use_flip=False,
        compute_dtype=torch.float32)
    state, metrics = step(state, spec["batch"])
    out = {"loss": float(metrics["loss"]),
           "params": whole_params(state.params),
           "c3d_moved": {k: float((v - before[k]).abs().max())
                         for k, v in state.c3d_params.items()}}
    if finetune:
        out["c3d"] = c3d_params_to_jax(state.c3d_params)
    return out


def evaluate(spec, mesh):
    fn = parallel.make_sharded_evaluate(mesh, metrics=spec["metrics"])
    out = fn(spec["pred"], spec["gt"], spec["fixation"],
             other_map=torch.as_tensor(spec["other_map"]))
    return {m: v.numpy() for m, v in out.items()}


class Recorder:
    def __init__(self):
        self.rows = []

    def __call__(self, step, values):
        self.rows.append((step, dict(values)))


def fit_run(spec, mesh):
    """`fit` on the mesh from (or into) the train dirs the test made:
    each entry of spec["runs"] is (train_dir, max_steps), on a fresh
    synthetic corpus of spec["splits"]."""
    out = []
    for train_dir, max_steps in spec["runs"]:
        exp = copy.deepcopy(spec["exp"])
        exp.schedule.max_steps = max_steps
        model = registry.create_model(
            exp.model.name, exp.model, device="cpu",
            generator=torch.Generator().manual_seed(exp.seed))
        state, tx = create_train_state(model, exp.optimizer)
        writer = Recorder()
        data = synthetic.make_splits(**spec["splits"])
        fit(model, state, tx, data, exp, train_dir=train_dir,
            metric_writer=writer, max_eval_instances=4, mesh=mesh)
        out.append(writer.rows)
    return {"rows": out}


def checkpoint_views(spec, mesh):
    """Each rank checkpoints into its own spec["dirs"][rank], where step 2
    exists in rank 0's only: a save of step 2 is skipped on every rank
    (no rank waits in a collective the others left out), a save of step
    3 is written by rank 0 alone, and `restore_latest` picks rank 0's step
    3, which rank 1 cannot see, so every rank raises."""
    model = model_of(spec)
    state, _ = create_train_state(model, OptimizerConfig(**spec["opt"]))
    train_dir = spec["dirs"][mesh.rank]
    state.step = 2
    if mesh.rank == 0:
        Checkpointer(train_dir).save(state)
    ckpt = Checkpointer(train_dir, mesh=mesh)
    model_dir = os.path.join(train_dir, "model")
    steps = []
    for step in (2, 3):
        state.step = step
        ckpt.save(state)
        steps.append(sorted(os.listdir(model_dir))
                     if os.path.isdir(model_dir) else [])
    try:
        ckpt.restore_latest(state)
        raised = None
    except FileNotFoundError as e:
        raised = str(e)
    return {"steps": steps, "raised": raised,
            "after": mesh.broadcast_object(mesh.rank)}


def temporal_predict(spec, mesh):
    model = model_of(spec)
    fn = parallel.make_temporal_sharded_fused_predict(
        model, mesh, compute_dtype=torch.float32)
    c3d = c3d_params_from_jax(spec["c3d"])
    out = {"maps": fn(c3d, spec["video"]).numpy(), "errors": []}
    for bad in spec["bad_videos"]:
        try:
            fn(c3d, bad)
        except ValueError as e:
            out["errors"].append(str(e))
    return out


def temporal_extract(spec, mesh):
    fn = parallel.make_temporal_sharded_extract(mesh,
                                                compute_dtype=torch.float32)
    c3d = c3d_params_from_jax(spec["c3d"])
    out = {"feats": fn(c3d, spec["video"]).numpy(), "errors": []}
    for bad in spec["bad_videos"]:
        try:
            fn(c3d, bad)
        except ValueError as e:
            out["errors"].append(str(e))
    return out


def cli(spec, mesh):
    """The CLIs under this job's world (their own mesh from the
    environment): train_gaze with --data_parallel -1, evaluate_gaze with
    --data_parallel N on its run, then train_fused with --data_parallel
    N (fit_fused on the mesh)."""
    from recurrent_gaze_prediction_tpu_torch.cli import (evaluate_gaze,
                                                         train_fused,
                                                         train_gaze)

    rcs = [train_gaze.main(spec["train"]), evaluate_gaze.main(spec["eval"]),
           train_fused.main(spec["fused"])]
    return {"rcs": rcs}


SCENARIOS = {f.__name__: f for f in (
    train, shard_batch, predict, stream, fused_predict, fused_train,
    evaluate, checkpoint_views, fit_run, temporal_predict, temporal_extract,
    cli)}


def main() -> int:
    workdir, names = sys.argv[1], sys.argv[2:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            timeout=datetime.timedelta(seconds=120))
    rank, world = dist.get_rank(), dist.get_world_size()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    data, model_size = inputs["mesh"]
    mesh = parallel.make_mesh(data, model_size,
                              devices=inputs.get("devices", ["cpu"] * world))
    for name in names:
        key = name.split(":")[0]
        try:
            result = SCENARIOS[key](inputs[name], mesh)
        except Exception:  # recorded for the test to report
            result = {"error": traceback.format_exc()}
        torch.save(result, os.path.join(workdir, f"{name}.rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def launch(workdir: str, world: int, inputs: dict, scenarios: list,
           timeout: float = 300.0) -> dict:
    """Run `scenarios` on `world` worker processes (this file), with the
    timeout `timeout` in all: a worker still running then is killed and
    the launch fails. Returns {scenario: [result of rank 0, ...]}."""
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    envs = [dict(env, OMP_NUM_THREADS="1") for env in rank_envs(world)]
    done = run_processes(
        [[sys.executable, os.path.abspath(__file__), workdir, *scenarios]
         for _ in range(world)], envs, timeout)
    rcs, logs = [rc for rc, _ in done], [log for _, log in done]
    if any(rcs):
        raise RuntimeError(f"workers exited {rcs}:\n" + "\n".join(
            log[-3000:] for log in logs))
    return {name: [torch.load(os.path.join(workdir, f"{name}.rank{r}.pt"),
                              weights_only=False) for r in range(world)]
            for name in scenarios}


def results_of(results: dict, name: str) -> list:
    """The ranks' results of one scenario; raises with the first rank's
    traceback if it failed."""
    for r in results[name]:
        if "error" in r:
            raise AssertionError(f"{name} failed on a rank:\n{r['error']}")
    return results[name]


if __name__ == "__main__":
    sys.exit(main())
