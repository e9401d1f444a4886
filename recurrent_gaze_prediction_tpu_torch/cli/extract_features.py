"""C3D feature extraction on the card: video files -> `.c3d` feature files.
The port's counterpart of the JAX package's `cli/extract_features.py`
(the reference's offline pipeline, `extract_C3D_features.py:801-926`, and
its batch script `extract_C3D_features_script.py:12-21`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.extract_features \\
        --videos_root /data/videos --out_dir /data/vid_c3d \\
        [--caffemodel c3d.caffemodel | --params c3d.npz] [--device cpu]

Each video is decoded (cv2, or imageio with ffmpeg or pyav), cut into
16-frame windows at every start of range(0, num_frames, 16), the tail
zero-padded, and the Sports-1M C3D tower runs on the windows on the card
(`models/c3d.py`: cuDNN, bf16, channels-last-3d). The per-window feature
blobs are pickled into `{video_id}.c3d` for `cli.extract_map` and the
action task. Windows travel to the card as uint8 through pinned buffers
and are preprocessed there; at most `max_inflight_chunks` chunks of
`--batch_windows` windows are in flight, and each chunk's features are
read back only once its event has completed.

`--attention_maps_root` is the reference's gaze-weighted variant
(`add_attention`, `extract_C3D_features.py:739-761`): each frame is
multiplied on the card by the gaze map of `cli.extract_map` that belongs
to it (`{video_id}.gazemap.npy`), max-normalized per map.

Weights: `--caffemodel` (a Sports-1M .caffemodel, `compat/caffemodel.py`),
`--params` (an .npz in the JAX package's layouts, flat keys like conv1a_w
or conv1a/w, as its CLI reads; any other file is the port's own params
file of `train.save_params`), or, with neither, random weights with a
loud warning (good for pipeline tests only).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..bridge import c3d_params_from_jax
from ..data import codec, video
from ..models import c3d as c3d_model
from ..utils import log, mkdir_p, resolve_device

VIDEO_SUFFIXES = (".avi", ".mp4", ".mkv", ".mov")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--videos", nargs="*", default=None,
                        help="video files to process")
    parser.add_argument("--videos_root", default=None,
                        help="directory scanned for video files "
                             "(.avi/.mp4/.mkv/.mov)")
    parser.add_argument("--out_dir", required=True,
                        help="writes {video_id}.c3d per video")
    parser.add_argument("--frames_dir", default=None,
                        help="also dump width-400 frame JPEGs per video "
                             "(Pillow), like the reference's extract_frames")
    parser.add_argument("--feature_layer", default="conv5b",
                        choices=list(c3d_model.FEATURE_LAYERS))
    parser.add_argument("--caffemodel", default=None,
                        help="Sports-1M .caffemodel to load weights from")
    parser.add_argument("--params", default=None,
                        help=".npz of C3D params in the JAX package's "
                             "layouts, or a params file of this package")
    parser.add_argument("--attention_maps_root", default=None,
                        help="directory of {video_id}.gazemap.npy maps; "
                             "frames are gaze-weighted before extraction")
    parser.add_argument("--batch_windows", default=16, type=int,
                        help="16-frame windows per device batch")
    parser.add_argument("--compute_dtype", default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="tower compute dtype (float32: TF32 off)")
    parser.add_argument("--bgr", default=None, action="store_true",
                        help="reorder decoded RGB frames to BGR before the "
                             "network (Caffe's order). Default: on when "
                             "--caffemodel is given, off otherwise")
    parser.add_argument("--no_bgr", dest="bgr", action="store_false")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--reverse", action="store_true",
                        help="sweep the video list from the end (two-worker "
                             "sharding)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def _load_params(args, device: torch.device) -> dict:
    """The tower's weights on `device`, from --caffemodel, --params, or a
    seeded random draw."""
    if args.caffemodel:
        from ..compat import caffemodel

        log.infov("loading C3D weights from %s", args.caffemodel)
        params = caffemodel.c3d_params_from_caffemodel(args.caffemodel)
    elif args.params and args.params.endswith(".npz"):
        log.infov("loading C3D params (JAX layouts) from %s", args.params)
        with np.load(args.params) as blob:
            params = c3d_params_from_jax(
                {key.replace("/", "_"): blob[key] for key in blob.files})
    elif args.params:
        from ..train.checkpoint import load_params

        log.infov("loading C3D params from %s", args.params)
        params = load_params(args.params)
    else:
        log.error("no --caffemodel/--params given: using RANDOM weights "
                  "(features are only useful for pipeline testing)")
        return c3d_model.init_params(torch.Generator().manual_seed(0),
                                     device=device)
    return {k: v.to(device) for k, v in params.items()}


def blob_layout(features: np.ndarray) -> np.ndarray:
    """One window's tap -> the reference blob layout. The port's conv taps
    are NCDHW, so a window's [C, D, H, W] already is the blob's (channel,
    length, height, width; `read_binary_blob`,
    `extract_C3D_features.py:62-76`); flat fc/prob taps become
    [C, 1, 1, 1]."""
    if features.ndim == 4:
        return np.ascontiguousarray(features)
    return features.reshape(-1, 1, 1, 1)


def attention_frame_index(n_frames: int, n_maps: int) -> np.ndarray:
    """Raw frame -> gaze map index for attention weighting.

    Gaze maps come one per SUBSAMPLED model frame: map k was produced for
    raw frame 15 + 5k (the `[15::5]` protocol, the reference's
    `crc_input_data_seq.py:186`), so raw frame i takes map round((i-15)/5)
    clipped into range. (The reference's own `add_attention` stretches
    the maps with np.resize, `extract_C3D_features.py:739-761`; this is
    the JAX package's corrected alignment.)
    """
    return np.clip(np.round((np.arange(n_frames) - 15) / 5.0).astype(int),
                   0, n_maps - 1)


def normalize_attention(maps: np.ndarray) -> np.ndarray:
    """Each map divided by its peak, so softmax probability maps (cells
    ~1/2401) weight the frame relatively instead of blacking it out."""
    maps = np.asarray(maps, np.float32)
    peaks = maps.max(axis=(-2, -1), keepdims=True)
    return maps / np.maximum(peaks, 1e-12)


def extract_windows(params: dict, frames: np.ndarray, *,
                    feature_layer: str = "conv5b", batch_windows: int = 16,
                    compute_dtype: str = "bfloat16", bgr: bool = False,
                    attention_maps: Optional[np.ndarray] = None,
                    max_inflight_chunks: int = 4,
                    device=None) -> list[np.ndarray]:
    """The window loop over one decoded video: frames [F, H, W, 3] uint8
    -> one blob per 16-frame window (`blob_layout`), on `device` (None =
    the card; `params` must live there).

    Every start of `clip_windows(F)` gives a window; the tail window is
    zero-padded. A chunk of up to `batch_windows` windows is staged in a
    pinned uint8 buffer, copied without blocking, gaze-weighted
    (`attention_maps`, [n_maps, GH, GW], already normalized) and
    preprocessed on the device, run through the tower, and copied back
    into a pinned buffer behind an event. Up to `max_inflight_chunks`
    chunks are queued; a chunk's features are read on the host only after
    its event has completed. The staging buffers form a ring one longer
    than that, so a buffer is refilled only after its chunk completed.
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    frames = np.asarray(frames, np.uint8)
    n_frames, h, w = frames.shape[:3]
    starts = c3d_model.clip_windows(n_frames)
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None

    att = att_idx = None
    if attention_maps is not None:
        att = torch.from_numpy(np.asarray(attention_maps, np.float32)).to(dev)
        att_idx = attention_frame_index(n_frames, len(att))

    ring = max_inflight_chunks + 1
    staged = [torch.empty((batch_windows, 16, h, w, 3), dtype=torch.uint8,
                          pin_memory=cuda) for _ in range(min(
                              ring, -(-len(starts) // batch_windows)))]
    readback: list = [None] * len(staged)
    pending: list = []
    blobs: list = []

    def collect() -> None:
        slot, valid, event = pending.pop(0)
        if event is not None:
            event.synchronize()
        # a copy: the pinned buffer is refilled by a later chunk
        feats = readback[slot][:valid].numpy().copy()
        blobs.extend(blob_layout(f) for f in feats)

    for chunk_id, first in enumerate(range(0, len(starts), batch_windows)):
        chunk_starts = starts[first:first + batch_windows]
        valid = len(chunk_starts)
        slot = chunk_id % len(staged)
        host = staged[slot]
        for i, s in enumerate(chunk_starts):
            n = min(16, n_frames - s)
            host[i, :n].copy_(torch.from_numpy(frames[s:s + n]))
            if n < 16:
                host[i, n:].zero_()
        x = host[:valid].to(dev, non_blocking=True)
        if att is not None:
            # the padded tail frames are zero: any map weights them to zero
            idx = np.concatenate([att_idx[np.minimum(
                np.arange(s, s + 16), n_frames - 1)] for s in chunk_starts])
            x = video.apply_attention(
                x.reshape(valid * 16, h, w, 3),
                att[torch.from_numpy(idx).to(dev)]).reshape(valid, 16, h, w, 3)
        with torch.inference_mode():
            feats = c3d_model.apply(
                params, c3d_model.preprocess_frames(x, bgr=bgr),
                feature_layer=feature_layer, compute_dtype=cdt)
        if readback[slot] is None or readback[slot].shape[1:] != \
                feats.shape[1:]:
            readback[slot] = torch.empty((batch_windows, *feats.shape[1:]),
                                         dtype=torch.float32, pin_memory=cuda)
        readback[slot][:valid].copy_(feats, non_blocking=True)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        pending.append((slot, valid, event))
        if len(pending) > max_inflight_chunks:
            collect()
    while pending:
        collect()
    return blobs


def extract_video(params: dict, video_path: str, out_file: str, *,
                  feature_layer: str = "conv5b", batch_windows: int = 16,
                  compute_dtype: str = "bfloat16", bgr: bool = False,
                  frames_dir: Optional[str] = None,
                  attention_maps: Optional[np.ndarray] = None,
                  max_inflight_chunks: int = 4, device=None) -> int:
    """Decode one video, extract its per-window features on `device`,
    write `.c3d`. Returns the number of 16-frame windows written."""
    # frames stay uint8 up to the device: a long video in f32 would be 4x
    # the decoded footprint before a single window runs
    decoded = [np.asarray(f, np.uint8) for f in video.decode_video(video_path)]
    if not decoded:
        raise IOError(f"no frames decoded from {video_path}")
    frames = np.stack(decoded)
    del decoded
    if frames_dir is not None:  # dump from memory; don't decode twice
        from PIL import Image

        video_id = os.path.splitext(os.path.basename(video_path))[0]
        dump_dir = os.path.join(frames_dir, video_id)
        mkdir_p(dump_dir)
        for i in range(len(frames)):
            Image.fromarray(video.resize_to_width(frames[i])).save(
                os.path.join(dump_dir, f"{i:06d}.jpg"))
    if attention_maps is not None:
        attention_maps = normalize_attention(attention_maps)
    blobs = extract_windows(
        params, frames, feature_layer=feature_layer,
        batch_windows=batch_windows, compute_dtype=compute_dtype, bgr=bgr,
        attention_maps=attention_maps,
        max_inflight_chunks=max_inflight_chunks, device=device)
    codec.write_c3d_file(out_file, blobs)
    return len(blobs)


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    videos = list(args.videos or [])
    if args.videos_root:
        videos.extend(
            os.path.join(args.videos_root, f)
            for f in sorted(os.listdir(args.videos_root))
            if f.lower().endswith(VIDEO_SUFFIXES))
    if not videos:
        log.error("no videos: pass --videos and/or --videos_root")
        return 1
    if args.reverse:
        videos = videos[::-1]
    mkdir_p(args.out_dir)

    params = _load_params(args, device)
    if args.compute_dtype == "bfloat16":
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    # Caffe-trained weights saw BGR frames and decoded frames are RGB:
    # reorder by default exactly when real caffemodel weights are in play
    bgr = args.bgr if args.bgr is not None else args.caffemodel is not None
    n_done = n_skipped = n_failed = 0
    for path in videos:
        video_id = os.path.splitext(os.path.basename(path))[0]
        out_file = os.path.join(args.out_dir, video_id + ".c3d")
        if not args.overwrite and os.path.exists(out_file):
            n_skipped += 1
            continue
        attention = None
        if args.attention_maps_root:
            map_file = os.path.join(args.attention_maps_root,
                                    video_id + ".gazemap.npy")
            if not os.path.exists(map_file):
                log.warn("no gaze map for %s (%s): skipping", video_id,
                         map_file)
                n_skipped += 1
                continue
            attention = np.load(map_file).astype(np.float32)
        try:
            n_windows = extract_video(
                params, path, out_file, feature_layer=args.feature_layer,
                batch_windows=args.batch_windows,
                compute_dtype=args.compute_dtype, bgr=bgr,
                frames_dir=args.frames_dir, attention_maps=attention,
                device=device)
        except (OSError, ValueError) as e:  # an unreadable video: go on
            log.error("failed on %s: %s", path, e)
            n_failed += 1
            continue
        log.info("wrote %s (%d windows)", out_file, n_windows)
        n_done += 1
    log.infov("done: %d extracted, %d skipped, %d failed", n_done,
              n_skipped, n_failed)
    return 0 if n_failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
