#!/usr/bin/env python3
"""Convert the JAX package's checkpoints into the PyTorch port's.

    # a run of the JAX package's cli.train_gaze -> a run of the port
    python scripts/convert_jax_checkpoint.py \\
        --train_dir runs/jax_grcn --out_dir runs/torch_grcn
    # a params file of the JAX package's cli.pretrain_shallownet (orbax)
    # -> the port's save_params file (cli.train_gaze --shallownet_pretrain)
    python scripts/convert_jax_checkpoint.py \\
        --params runs/shallownet_orbax --out runs/shallownet.pt

A run: the latest orbax checkpoint under `{train_dir}/model/` (params,
optax state, step) is restored with the JAX package's `Checkpointer`, then
written as the port's `{out_dir}/model/<step>/state.pt` with
`config.json` beside it, through `bridge.params_from_jax` and
`bridge.opt_state_from_jax`: the port's CLIs (`cli.train_gaze` resumes
it, `cli.evaluate_gaze`, `cli.extract_map`, `cli.export_serving`) then
read it as their own. A run of the fused trainer is not converted (its
state holds the C3D tower too).

The script imports jax, orbax and the JAX package, so it runs where those
are installed, on the CPU; the port itself imports none of them.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from recurrent_gaze_prediction_tpu import registry as jregistry  # noqa: E402
from recurrent_gaze_prediction_tpu.train import (  # noqa: E402
    Checkpointer as JCheckpointer)
from recurrent_gaze_prediction_tpu.train import (  # noqa: E402
    create_train_state as jcreate_train_state)
from recurrent_gaze_prediction_tpu_torch import registry  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.bridge import (  # noqa: E402
    opt_state_from_jax, params_from_jax)
from recurrent_gaze_prediction_tpu_torch.config import (  # noqa: E402
    ExperimentConfig)
from recurrent_gaze_prediction_tpu_torch.train import (  # noqa: E402
    Checkpointer, create_train_state, save_params)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def convert_run(train_dir: str, out_dir: str) -> int:
    """The latest checkpoint of the JAX run `train_dir` -> a port run in
    `out_dir`; returns its step."""
    jexp = JCheckpointer.load_config(train_dir)
    jmodel = jregistry.create_model(jexp.model.name, jexp.model)
    jstate, _ = jcreate_train_state(jmodel, jexp.optimizer,
                                    jax.random.PRNGKey(0))
    ckpt = JCheckpointer(train_dir)
    try:
        restored = ckpt.restore_latest(jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), jstate))
    finally:
        ckpt.close()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found under {train_dir}")

    exp = ExperimentConfig.load(os.path.join(train_dir, "config.json"))
    exp.train_dir = out_dir
    model = registry.create_model(exp.model.name, exp.model, device="cpu")
    model.load_state_dict(params_from_jax(_numpy(restored.params)))
    state, _ = create_train_state(model, exp.optimizer)
    moments = opt_state_from_jax(_numpy(restored.opt_state))
    with torch.no_grad():
        for key, value in state.opt_state.items():
            if key == "count":
                state.opt_state["count"] = moments["count"]
            else:  # only the trained parameters' moments: the port's keys
                for name, t in value.items():
                    t.copy_(moments[key][name])
    state.step = int(restored.step)
    out = Checkpointer(out_dir)
    out.save(state)
    out.save_config(exp)
    return state.step


def convert_params(path: str, out: str) -> None:
    """A params-only orbax checkpoint of the JAX package (`save_params`,
    e.g. a pretrained ShallowNet) -> the port's `save_params` file."""
    ckptr = ocp.StandardCheckpointer()
    try:
        meta = ckptr.metadata(os.path.abspath(path))
        cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
        abstract = jax.tree_util.tree_map(
            lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu),
            getattr(meta, "item_metadata", meta))
        params = ckptr.restore(os.path.abspath(path), abstract)
    finally:
        ckptr.close()
    save_params(out, params_from_jax(_numpy(params)))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--train_dir", default=None,
                        help="a run of the JAX package (config.json, "
                             "model/<step>/)")
    parser.add_argument("--out_dir", default=None,
                        help="the port's run to write (with --train_dir)")
    parser.add_argument("--params", default=None,
                        help="a params-only orbax checkpoint of the JAX "
                             "package (cli.pretrain_shallownet --out)")
    parser.add_argument("--out", default=None,
                        help="the port's params file to write (with "
                             "--params; must not exist)")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.train_dir) == bool(args.params):
        parser.error("give --train_dir with --out_dir, or --params with "
                     "--out")
    if args.train_dir:
        if not args.out_dir:
            parser.error("--train_dir needs --out_dir")
        step = convert_run(args.train_dir, args.out_dir)
        print(f"converted {args.train_dir} (step {step}) -> {args.out_dir}")
    else:
        if not args.out:
            parser.error("--params needs --out")
        convert_params(args.params, args.out)
        print(f"converted {args.params} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
