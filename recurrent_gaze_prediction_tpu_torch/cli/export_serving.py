"""Export a trained run as a serving bundle: the port's counterpart of the
JAX package's `cli/export_serving.py`.

    python -m recurrent_gaze_prediction_tpu_torch.cli.export_serving \\
        --train_dir runs/grcn --out_dir runs/grcn/serving \\
        --stream_chunk_len 42 \\
        [--caffemodel sports1m.caffemodel --fused_num_frames 160] \\
        [--int8 --calib_videos videos/ --calib_windows 8]

Restores the run's latest checkpoint (`train/checkpoint.Checkpointer`) at
`--n_lstm_steps` (default: the run's T) and writes it with
`serving.save_bundle`: the `predict` program, the `stream` chunk step with
`--stream_chunk_len` (gaze_grcn only), and the raw-video `fused` program
with `--caffemodel` (a `.caffemodel`, its BGR order folded into conv1a, or
an `.npz` of the JAX package's flat C3D layout), and with `--int8` also
`fused_int8`, the same program on the int8 tower (`models/quant.py`),
its activation scales calibrated on up to `--calib_windows` 16-frame
windows decoded from the videos under `--calib_videos` (synthetic noise,
with a warning, when none decode). Serve the bundle with `cli.serve`; the
JAX package's `load_bundle` reads its config and weights too.

`--platforms` and `--static_batch` describe the JAX package's
ahead-of-time (`jax.export`) programs, which a bundle of the port does not
hold: they are accepted and change nothing.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..models import c3d as c3d_model
from ..models.quant import quantize_for_pipeline
from ..ops.layers import resize_bilinear
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
                        help="also export the fused program with an "
                             "int8-quantized C3D tower (requires "
                             "--caffemodel)")
    parser.add_argument("--calib_videos", default=None,
                        help="directory of videos to calibrate the int8 "
                             "activation scales on (recommended; falls "
                             "back to synthetic noise with a warning)")
    parser.add_argument("--calib_windows", default=8, type=int,
                        help="max 16-frame windows used for calibration")
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


def load_calibration_clips(calib_videos: Optional[str], max_windows: int,
                           device: torch.device) -> Optional[torch.Tensor]:
    """Decode up to `max_windows` 16-frame windows from a directory of
    videos (`data.video.decode_video`: cv2, else imageio) and preprocess
    them as C3D network inputs on `device` (resized to 128x171 on the
    host first, as the JAX package does, so windows of differently sized
    videos stack). None (-> synthetic calibration, with a warning) when no
    directory is given or no window decodes."""
    if not calib_videos:
        return None
    from ..data import video as video_mod

    windows = []
    paths = sorted(p for p in glob.glob(os.path.join(calib_videos, "*"))
                   if os.path.isfile(p))
    for path in paths:
        try:
            frames = [np.asarray(f, np.float32)
                      for f in video_mod.decode_video(path)]
        except Exception as e:
            log.warn("calibration: cannot decode %s: %s", path, e)
            continue
        for start in range(0, len(frames) - 15, 16):
            win = torch.from_numpy(np.stack(frames[start:start + 16]))
            if tuple(win.shape[1:3]) != c3d_model.RESIZE_HW:
                win = resize_bilinear(win, c3d_model.RESIZE_HW)
            windows.append(win)
            if len(windows) >= max_windows:
                break
        if len(windows) >= max_windows:
            break
    if not windows:
        log.warn("calibration: no decodable 16-frame windows under %s",
                 calib_videos)
        return None
    log.infov("int8 calibration on %d real windows from %s", len(windows),
              calib_videos)
    return c3d_model.preprocess_frames(torch.stack(windows).to(device))


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.int8 and not args.caffemodel:
        log.error("--int8 quantizes the C3D tower; pass --caffemodel")
        return 1
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

    int8_qparams = None
    if args.int8:
        # calibrated on the weights the bundle carries (BGR folded in)
        calib = load_calibration_clips(args.calib_videos, args.calib_windows,
                                       device)
        int8_qparams = quantize_for_pipeline(c3d_params, calib_clips=calib)

    save_bundle(args.out_dir, model, wire_dtype=args.wire_dtype,
                stream_chunk_len=args.stream_chunk_len,
                c3d_params=c3d_params, num_frames=num_frames,
                video_dtype=args.video_dtype, int8_qparams=int8_qparams)
    programs = ["predict"] + (["stream"] if args.stream_chunk_len else []) \
        + (["fused"] if c3d_params is not None else []) \
        + (["fused_int8"] if int8_qparams is not None else [])
    log.infov("serving bundle written to %s (T=%d, programs %s)",
              args.out_dir, t, ", ".join(programs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
