"""Export a trained run as a serving bundle: the port's counterpart of the
JAX package's `cli/export_serving.py`.

    python -m recurrent_gaze_prediction_tpu_torch.cli.export_serving \\
        --train_dir runs/grcn --out_dir runs/grcn/serving \\
        --stream_chunk_len 42 \\
        [--caffemodel sports1m.caffemodel --fused_num_frames 160]

Restores the run's latest checkpoint (`train/checkpoint.Checkpointer`) at
`--n_lstm_steps` (default: the run's T) and writes it with
`serving.save_bundle`: the `predict` program, the `stream` chunk step with
`--stream_chunk_len` (gaze_grcn only), and the raw-video `fused` program
with `--caffemodel` (a `.caffemodel`, its BGR order folded into conv1a, or
an `.npz` of the JAX package's flat C3D layout). Serve the bundle with
`cli.serve`; the JAX package's `load_bundle` reads its config and weights
too.

`--platforms` and `--static_batch` describe the JAX package's
ahead-of-time (`jax.export`) programs, which a bundle of the port does not
hold: they are accepted and change nothing. Not ported yet, and refused
with exit code 2: `--int8`, `--calib_videos` and `--calib_windows`, the
int8 C3D tower (ROADMAP.md queue A item 3).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from ..registry import create_model
from ..serving import save_bundle
from ..train import Checkpointer, create_train_state
from ..utils import log, resolve_device
from .train_fused import load_c3d_params


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--n_lstm_steps", default=None, type=int,
                        help="T of the exported predict program "
                             "(default: the run's training T)")
    parser.add_argument("--platforms", default=None,
                        help="accepted for the JAX command line: jax.export "
                             "targets, which a bundle of the port does not "
                             "hold")
    parser.add_argument("--caffemodel", default=None,
                        help="Sports-1M .caffemodel, or an .npz of the JAX "
                             "package's flat C3D layout; adds the fused "
                             "raw-video program")
    parser.add_argument("--fused_num_frames", default=160, type=int,
                        help="raw-frame clip length of the fused program")
    parser.add_argument("--stream_chunk_len", default=None, type=int,
                        help="add the carried-state streaming chunk step "
                             "(gaze_grcn only)")
    parser.add_argument("--int8", action="store_true",
                        help="not ported yet (ROADMAP.md queue A item 3): "
                             "exits 2")
    parser.add_argument("--calib_videos", default=None,
                        help="not ported yet (ROADMAP.md queue A item 3): "
                             "exits 2")
    parser.add_argument("--calib_windows", default=None, type=int,
                        help="not ported yet (ROADMAP.md queue A item 3): "
                             "exits 2")
    parser.add_argument("--static_batch", action="store_true",
                        help="accepted for the JAX command line: a jax.export "
                             "option that changes nothing here")
    parser.add_argument("--wire_dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="input dtype of the predict and stream "
                             "programs' frames and features; the server "
                             "casts incoming payloads to it")
    parser.add_argument("--video_dtype", default="float32",
                        choices=("float32", "uint8"),
                        help="input dtype of the fused program's pixels; "
                             "uint8 is exact for decoded video")
    parser.add_argument("--device", default="cuda",
                        help="torch device to restore on; the default needs "
                             "a CUDA card")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.int8 and not args.caffemodel:
        log.error("--int8 quantizes the C3D tower; pass --caffemodel")
        return 1
    if args.int8 or args.calib_videos or args.calib_windows is not None:
        parser.error("--int8 / --calib_videos / --calib_windows: the int8 C3D "
                     "tower is not ported yet (ROADMAP.md queue A item 3)")
    for flag, given in (("--platforms", args.platforms is not None),
                        ("--static_batch", args.static_batch)):
        if given:
            log.warn("%s describes jax.export programs, which a bundle of "
                     "this package does not hold: it changes nothing", flag)
    device = resolve_device(args.device)

    exp = Checkpointer.load_config(args.train_dir)
    t = args.n_lstm_steps or exp.model.n_lstm_steps
    model = create_model(exp.model.name, exp.model, device=device,
                         n_lstm_steps=t)
    state, _ = create_train_state(model, exp.optimizer)
    if Checkpointer(args.train_dir).restore_latest(state) is None:
        log.error("no checkpoint found under %s", args.train_dir)
        return 1

    c3d_params = num_frames = None
    if args.caffemodel:
        c3d_params = load_c3d_params(args.caffemodel, torch.Generator(),
                                     device)
        num_frames = args.fused_num_frames

    save_bundle(args.out_dir, model, wire_dtype=args.wire_dtype,
                stream_chunk_len=args.stream_chunk_len,
                c3d_params=c3d_params, num_frames=num_frames,
                video_dtype=args.video_dtype)
    programs = ["predict"] + (["stream"] if args.stream_chunk_len else []) \
        + (["fused"] if c3d_params is not None else [])
    log.infov("serving bundle written to %s (T=%d, programs %s)",
              args.out_dir, t, ", ".join(programs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
