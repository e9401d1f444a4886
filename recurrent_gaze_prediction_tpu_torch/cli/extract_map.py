"""Bulk gaze-map export on the card: the port's counterpart of the JAX
package's `cli/extract_map.py` (the reference's `models/extract_map.py`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.extract_map \\
        --train_dir RUN --clips_root /data/vid_frm --c3d_root /data/vid_c3d \\
        --out_dir /data/maps [--streaming] [--device cpu]

Restores a run of `cli.train_gaze` (config.json and its latest
checkpoint) and, per clip folder, zero-pads or truncates the clip's
`.c3d` features and subsampled frames to `--n_lstm_steps` (default 105,
`extract_map.py:65`), predicts `--batch_size` clips per call (the last
batch padded by repeating its last clip), and saves `{clip}.gazemap.npy`
(float16, the clip's valid frames) and, for 49x49 maps, the 7x7
average-pooled `{clip}.gazemap7x7.npy` (`extract_map.py:228-238`). Clips
whose maps exist are skipped (idempotent resume); `--reverse` sweeps the
list from the end, for two workers.

`--streaming` carries the recurrent state across `--chunk_len` chunks of
the whole clip instead (gaze_grcn through `models/streaming.stream_video`,
gaze_lstm through `lstm_stream_step`), with no truncation and no restart
at chunk boundaries; it saves the raw per-frame maps the streaming steps
return, as the JAX package does.

Frame files are read with Pillow; a clip folder with no frame file gives
one zero frame, so a feature-fed model needs no Pillow on the card.
`--data_parallel N` (> 1) splits each batch's clips over a mesh of N
ranks launched by torchrun (`parallel.make_sharded_predict`; a batch that
does not divide is zero-padded, with a warning); rank 0 alone writes the
maps, and which clips are done is rank 0's view.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..data import codec
from ..data.prefetch import device_put_batch, stream_casts
from ..parallel import make_sharded_predict
from ..parallel.mesh import cli_mesh, close_cli_meshes
from ..models import streaming
from ..registry import create_model
from ..train import Checkpointer, create_train_state, make_predict_fn
from ..train.loop import input_dtype_of
from ..utils import log, mkdir_p, resolve_device

FRAME_SUFFIXES = (".jpg", ".jpeg", ".png")


def avg_pool_7x7(maps: np.ndarray) -> np.ndarray:
    """[T, 49, 49] -> [T, 7, 7] mean pooling (`extract_map.py:35-41`)."""
    t = maps.shape[0]
    return maps.reshape(t, 7, 7, 7, 7).mean(axis=(2, 4))


def pad_or_clip(stream: np.ndarray, t: int) -> np.ndarray:
    """Zero-pad short streams / truncate long ones to T
    (`extract_map.py:170-199`)."""
    if len(stream) >= t:
        return stream[:t]
    pad = np.zeros((t - len(stream),) + stream.shape[1:], stream.dtype)
    return np.concatenate([stream, pad], axis=0)


def load_clip_inputs(clip_dir: str, c3d_file: str, t: int,
                     image_hw=(98, 98)) -> dict:
    """One clip's features and [15::5] frames (LANCZOS to `image_hw`,
    scaled to [0, 1]), padded or truncated to T, and its valid length."""
    c3d = codec.load_c3d_for_model(c3d_file)
    frame_files = sorted(
        os.path.join(clip_dir, f) for f in os.listdir(clip_dir)
        if f.lower().endswith(FRAME_SUFFIXES))[15::5]
    frames = []
    if frame_files:
        from PIL import Image

        for path in frame_files:
            img = Image.open(path).convert("RGB").resize(
                (image_hw[1], image_hw[0]), Image.LANCZOS)
            frames.append(np.asarray(img))
    else:
        frames = [np.zeros((*image_hw, 3), np.uint8)]
    frames = np.stack(frames).astype(np.float32) / 255.0

    n_valid = min(len(frames), len(c3d), t)
    return {
        "frames": pad_or_clip(frames, t),
        "c3d": pad_or_clip(c3d, t),
        "n_valid": n_valid,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--clips_root", required=True,
                        help="directory of clip folders with frame JPEGs")
    parser.add_argument("--c3d_root", default=None,
                        help="directory of {clip}.c3d files (defaults to "
                             "clips_root)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--n_lstm_steps", default=105, type=int)
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--reverse", action="store_true")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--data_parallel", default=1, type=int,
                        help="ranks to split each batch over (a torchrun "
                             "job of that many processes)")
    parser.add_argument("--streaming", action="store_true",
                        help="carried-state chunked export of the whole "
                             "clip (gaze_grcn, gaze_lstm)")
    parser.add_argument("--chunk_len", default=42, type=int,
                        help="chunk length for --streaming")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def _save(out_dir: str, clip: str, maps: np.ndarray) -> None:
    """`{clip}.gazemap.npy` in float16, and its 7x7 pooling for 49x49
    maps."""
    maps = maps.astype(np.float16)
    np.save(os.path.join(out_dir, f"{clip}.gazemap.npy"), maps)
    if maps.shape[1:] == (49, 49):
        np.save(os.path.join(out_dir, f"{clip}.gazemap7x7.npy"),
                avg_pool_7x7(maps.astype(np.float32)).astype(np.float16))


def stream_clip(model, feats: np.ndarray, chunk_len: int) -> np.ndarray:
    """One clip's whole feature stream [T, 1024, 7, 7] through the model's
    carried-state streaming step -> [T, 49, 49] maps (f32, on the host)."""
    if model.cfg.name == "gaze_grcn":
        return np.concatenate(list(streaming.stream_video(
            model, feats, chunk_len=chunk_len)))
    dev = next(model.parameters()).device
    state = streaming.init_lstm_stream_state(1, model.cfg, device=dev)
    chunks = []
    for start in range(0, len(feats), chunk_len):
        chunk = pad_or_clip(feats[start:start + chunk_len], chunk_len)
        valid = min(chunk_len, len(feats) - start)
        state, maps = streaming.lstm_stream_step(
            model, state, torch.from_numpy(chunk[None]).to(dev))
        chunks.append(maps[0, :valid].float().cpu().numpy())
    return np.concatenate(chunks)


def export_streaming(args, model, clips: list, c3d_root: str) -> int:
    """Carried-state chunked export (`models/streaming.py`): the whole
    clip, no zero-state restart at chunk boundaries."""
    if model.cfg.name not in ("gaze_grcn", "gaze_lstm"):
        log.error("--streaming supports gaze_grcn / gaze_lstm (49x49 "
                  "conv decoders); run config has %s", model.cfg.name)
        return 1
    n_done = n_skipped = n_missing = 0
    for clip in clips:
        out_file = os.path.join(args.out_dir, f"{clip}.gazemap.npy")
        if not args.overwrite and os.path.exists(out_file):
            n_skipped += 1
            continue
        c3d_file = os.path.join(c3d_root, clip + ".c3d")
        if not os.path.exists(c3d_file):
            log.warn("missing c3d for %s, skipping", clip)
            n_missing += 1
            continue
        maps = stream_clip(model, codec.load_c3d_for_model(c3d_file),
                           args.chunk_len)
        _save(args.out_dir, clip, maps)
        log.info("saved %s (%d frames, streamed)", clip, len(maps))
        n_done += 1
    log.infov("done: %d exported (streaming), %d skipped, %d missing c3d",
              n_done, n_skipped, n_missing)
    if n_missing:
        log.error("%d clips had no .c3d file and were NOT exported",
                  n_missing)
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    try:
        return _main(argv)
    finally:
        close_cli_meshes()


def _main(argv: Optional[list[str]]) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh = (cli_mesh(args.data_parallel, 1, args.device)
            if args.data_parallel > 1 else None)
    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    c3d_root = args.c3d_root or args.clips_root
    if lead:
        mkdir_p(args.out_dir)

    exp = Checkpointer.load_config(args.train_dir)
    model = create_model(exp.model.name, exp.model, device=device,
                         n_lstm_steps=args.n_lstm_steps,
                         batch_size=args.batch_size)
    state, _ = create_train_state(model, exp.optimizer)
    if Checkpointer(args.train_dir).restore_latest(state) is None:
        log.error("no checkpoint found under %s", args.train_dir)
        return 1
    model.eval()

    clips = sorted(
        c for c in os.listdir(args.clips_root)
        if os.path.isdir(os.path.join(args.clips_root, c)))
    if args.reverse:
        clips = clips[::-1]

    if args.streaming:
        if mesh is not None:
            log.error("--streaming runs on one rank; drop --data_parallel")
            return 1
        return export_streaming(args, model, clips, c3d_root)

    cast = stream_casts(input_dtype_of(model))
    if mesh is not None:
        predict = make_sharded_predict(model, mesh)
        if args.batch_size % args.data_parallel:
            log.warn("batch_size %d not divisible by data_parallel %d",
                     args.batch_size, args.data_parallel)

        def inputs_of(host: dict) -> dict:
            # this rank's rows only are copied, inside the sharded predict
            return {k: torch.from_numpy(v).to(cast[k]) if cast
                    else torch.from_numpy(v) for k, v in host.items()}
    else:
        predict = make_predict_fn(model)

        def inputs_of(host: dict) -> dict:
            return device_put_batch(host, device, cast)
    pending, names = [], []

    def flush():
        if not pending:
            return
        while len(pending) < args.batch_size:  # pad the last batch
            pending.append(pending[-1])
        batch = inputs_of({k: np.stack([p[k] for p in pending])
                           for k in ("frames", "c3d")})
        with torch.inference_mode():
            maps = predict(batch["frames"], batch["c3d"]).float().cpu()
        if lead:
            for name, inputs, clip_maps in zip(names, pending, maps.numpy()):
                _save(args.out_dir, name, clip_maps[:inputs["n_valid"]])
                log.info("saved %s (%d frames)", name, inputs["n_valid"])
        pending.clear()
        names.clear()

    def exists(path: str) -> bool:
        # rank 0's view, so every rank batches the same clips
        found = os.path.exists(path)
        return found if mesh is None else mesh.broadcast_object(found)

    n_done = n_skipped = n_missing = 0
    for clip in clips:
        out_file = os.path.join(args.out_dir, f"{clip}.gazemap.npy")
        if not args.overwrite and exists(out_file):
            n_skipped += 1
            continue
        c3d_file = os.path.join(c3d_root, clip + ".c3d")
        if not os.path.exists(c3d_file):
            log.warn("missing c3d for %s, skipping", clip)
            n_missing += 1
            continue
        pending.append(load_clip_inputs(os.path.join(args.clips_root, clip),
                                        c3d_file, args.n_lstm_steps))
        names.append(clip)
        n_done += 1
        if len(pending) == args.batch_size:
            flush()
    flush()
    log.infov("done: %d exported, %d skipped (already present), "
              "%d missing c3d", n_done, n_skipped, n_missing)
    if n_missing:
        log.error("%d clips had no .c3d file and were NOT exported",
                  n_missing)
    return 0


if __name__ == "__main__":
    sys.exit(main())
