"""Train a gaze-prediction model on the card: the port's counterpart of the
JAX package's `cli/train_gaze.py`.

    python -m recurrent_gaze_prediction_tpu_torch.cli.train_gaze \\
        --dataset synthetic --max_steps 200 --train_dir /tmp/rgp

Model registry selection (all ten families), config overrides (CLI wins),
the synthetic corpus or the CRC / Hollywood2 loaders (`--dataset
crc|hollywood2|crcxh2 --data_root DIR`, h5py and Pillow on the host; the
reference's real-data defaults of batch 28 and lr 1e-4), an optional
pretrained ShallowNet grafted into the model (`--shallownet_pretrain`, a
file of `cli.pretrain_shallownet`), fit with auto-resume from
`--train_dir`, then the saliency metrics on the whole test split (written
as `test/<metric>`). The train step runs a ConvGRU the kernels take
through them (forward B1, backward B2) on the card. Training batches are
prefetched by a worker thread (cast on the host, copied on a side stream)
unless `--no_prefetch`. `--profile_steps N` traces N train steps from
step 3 on into `{train_dir}/profile` (torch.profiler, TensorBoard-viewable
`*.pt.trace.json`).

`--pallas` and `--no_pallas` are accepted for the JAX command lines and
change nothing: the route follows `kernel_takes` (a recurrence the kernels
take runs through them on the card, any other through the cell's own
scan).

`--data_parallel N` / `--model_parallel M` other than 1 train over a mesh
of ranks (`parallel.make_mesh`; -1 takes every rank left after the model
axis), one process per rank, launched by torchrun:

    torchrun --nproc_per_node 4 -m \
        recurrent_gaze_prediction_tpu_torch.cli.train_gaze \
        --data_parallel -1 --batch_size 28 --train_dir /tmp/rgp

Each rank takes the card LOCAL_RANK picks (`--device cpu`: the CPU, over
gloo), prefetches only its rows of each batch, and the final test-split
evaluation is split over the mesh too; rank 0 alone writes. A mesh larger
than the job raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from ..config import ExperimentConfig
from ..data import crc as crc_data
from ..data import synthetic
from ..data.datasets import DataSplits
from ..data.prefetch import prefetch_batches, stream_casts
from ..eval import evaluator
from ..parallel.mesh import cli_mesh, close_cli_meshes
from ..registry import available_models, create_model
from ..train import (create_train_state, fit, make_predict_fn,
                     restore_shallownet)
from ..train.loop import input_dtype_of
from ..train.writer import MetricWriter
from ..utils import log, resolve_device


def load_datasets(exp: ExperimentConfig, args) -> DataSplits:
    gh, gw = exp.model.gazemap_height, exp.model.gazemap_width
    if exp.dataset == "synthetic":
        return synthetic.make_splits(
            n_train=args.synthetic_clips,
            n_valid=max(args.synthetic_clips // 2, 2),
            n_test=max(args.synthetic_clips // 2, 2),
            t=exp.model.n_lstm_steps, gazemap_hw=(gh, gw), seed=exp.seed)
    layouts = crc_data.layouts_for(exp.dataset, args.data_root)
    # the window length follows the model's unroll length (the reference
    # keeps both at 42: SEQ_LEN `crc_input_data_seq.py:486`, n_lstm_steps
    # `models/gaze_rnn.py:50`)
    return crc_data.read_crc_data_sets(
        exp.model.image_height, exp.model.image_width, gh, gw,
        dataset=exp.dataset, layouts=layouts,
        seq_len=exp.model.n_lstm_steps, cache_dir=args.cache_dir,
        max_folders=args.max_folders)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--model", default="gaze_grcn",
                        choices=available_models())
    parser.add_argument("--dataset", default="synthetic",
                        choices=["crc", "hollywood2", "crcxh2", "synthetic"])
    parser.add_argument("--data_root", default=None,
                        help="dataset root (crcxh2: the parent of crc/ and "
                             "hollywood2/)")
    parser.add_argument("--cache_dir", default=None,
                        help="npz cache of the loaded splits")
    parser.add_argument("--max_folders", default=None, type=int,
                        help="clip folders per split (disables the cache)")
    parser.add_argument("--synthetic_clips", default=16, type=int)
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--learning_rate", default=None, type=float)
    parser.add_argument("--learning_rate_decay", default=None, type=float)
    parser.add_argument("--accum_steps", default=None, type=int,
                        help="gradient-accumulation microbatches per "
                             "optimizer update (memory lever; batch "
                             "size must divide evenly)")
    parser.add_argument("--max_steps", default=None, type=int)
    parser.add_argument("--steps_per_logprint", default=None, type=int,
                        help="log (and write to metrics.jsonl) every N "
                             "steps; each log reads the loss back")
    parser.add_argument("--loss_type", default=None,
                        choices=[None, "l2", "xentropy", "kld"])
    parser.add_argument("--n_lstm_steps", default=None, type=int)
    parser.add_argument("--train_dir", default=None)
    parser.add_argument("--train_tag", "--tag", default="")
    parser.add_argument("--shallownet_pretrain", default=None,
                        help="params file to graft into ShallowNet "
                             "(cli.pretrain_shallownet --out)")
    parser.add_argument("--compute_dtype", default=None,
                        choices=[None, "bfloat16", "float32"])
    parser.add_argument("--pallas", dest="use_pallas", action="store_true",
                        default=None,
                        help="accepted for the JAX command line; the route "
                             "follows kernel_takes either way")
    parser.add_argument("--no_pallas", dest="use_pallas",
                        action="store_false",
                        help="accepted for the JAX command line and maps to "
                             "nothing: it does not select the plain scan; "
                             "the route follows kernel_takes")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--no_prefetch", dest="prefetch",
                        action="store_false", default=True,
                        help="copy each training batch inline instead of "
                             "on the prefetch thread")
    parser.add_argument("--profile_steps", default=0, type=int,
                        help="trace N train steps (after warm-up) into "
                             "{train_dir}/profile (TensorBoard-viewable)")
    parser.add_argument("--data_parallel", default=1, type=int,
                        help="ranks on the data axis of the mesh (-1: all "
                             "left after the model axis); other than 1 "
                             "with --model_parallel 1 builds a mesh")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="ranks on the model axis of the mesh (the "
                             "wide products' weights split over it)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card "
                             "(under a mesh: the card LOCAL_RANK picks)")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    try:
        return _main(argv)
    finally:
        close_cli_meshes()


def _main(argv: Optional[list[str]]) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.use_pallas is not None:
        log.warn("--%spallas changes nothing here: the recurrence's route "
                 "follows kernel_takes", "" if args.use_pallas else "no_")
    if args.dataset != "synthetic" and not args.data_root:
        log.error("--data_root is required for dataset %s", args.dataset)
        return 1
    mesh = (cli_mesh(args.data_parallel, args.model_parallel, args.device)
            if args.data_parallel != 1 or args.model_parallel != 1 else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)

    exp = ExperimentConfig()
    exp.dataset = args.dataset
    exp.seed = args.seed
    exp.train_dir = args.train_dir
    exp.train_tag = args.train_tag
    exp.model.name = args.model
    if args.dataset != "synthetic":
        # the reference's training entry overrides the model-class defaults
        # for real data: batch 28 ("CRC likes 28"), lr 1e-4, cadences
        # 100/20/100 (`models/train_gaze.py:74-97`); the flags below win
        exp.model.batch_size = 28
        exp.optimizer.initial_learning_rate = 1e-4
        exp.schedule.steps_per_evaluation = 100
        exp.schedule.steps_per_validation = 20
        exp.schedule.steps_per_checkpoint = 100
    exp.apply_overrides({
        "model.batch_size": args.batch_size,
        "model.loss_type": args.loss_type,
        "model.n_lstm_steps": args.n_lstm_steps,
        "model.compute_dtype": args.compute_dtype,
        "optimizer.initial_learning_rate": args.learning_rate,
        "optimizer.learning_rate_decay": args.learning_rate_decay,
        "optimizer.accum_steps": args.accum_steps,
        "schedule.max_steps": args.max_steps,
        "schedule.steps_per_logprint": args.steps_per_logprint,
    })

    model = create_model(args.model, exp.model, device=device,
                         generator=torch.Generator().manual_seed(exp.seed))
    exp.model = model.cfg  # registry defaults applied

    log.warn("Loading %s input data ...", exp.dataset)
    data = load_datasets(exp, args)
    log.info("%s", data)

    log.warn("Building model %s on %s ...", args.model, device)
    state, tx = create_train_state(model, exp.optimizer)
    if args.shallownet_pretrain:
        restore_shallownet(model, args.shallownet_pretrain)
    lead = mesh is None or mesh.rank == 0
    writer = MetricWriter(exp.train_dir) if exp.train_dir and lead else None
    input_dtype = input_dtype_of(model)

    # max_batches bounds the worker; a resumed run stops consuming at
    # max_steps inside fit, and closing the generator stops the worker
    train_iter = (prefetch_batches(data.train, model.cfg.batch_size,
                                   device=device,
                                   cast=stream_casts(input_dtype),
                                   max_batches=exp.schedule.max_steps,
                                   mesh=mesh)
                  if args.prefetch else None)
    model_parallel = (args.model_parallel > 1) if mesh else None
    log.warn("Start fitting ...")
    try:
        state = fit(model, state, tx, data, exp, train_dir=exp.train_dir,
                    metric_writer=writer, train_iterator=train_iter,
                    profile_steps=args.profile_steps, mesh=mesh,
                    model_parallel=model_parallel)
        if data.test is not None and len(data.test) >= model.cfg.batch_size:
            log.warn("Final test-split evaluation ...")
            if mesh is not None:
                from ..parallel import make_sharded_predict

                predict = make_sharded_predict(model, mesh,
                                               model_parallel=model_parallel)
            else:
                predict = make_predict_fn(model)
            _, scores = evaluator.generate_and_evaluate(
                predict, data.test, model.cfg.batch_size,
                max_instances=None, input_cast=input_dtype, device=device,
                mesh=mesh)
            if writer:
                writer.scalars(state.step,
                               {f"test/{m}": s for m, s in scores.items()})
    finally:
        if train_iter is not None:
            train_iter.close()
        if writer:
            writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
