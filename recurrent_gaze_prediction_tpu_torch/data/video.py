"""Video frames for the C3D pipeline: the port's counterpart of the JAX
package's `data/video.py` (the reference's OpenCV stage,
`extract_C3D_features.py:113-178,739-761`).

  * `decode_video`: cv2 when it imports, then imageio with an ffmpeg or
    pyav backend; with neither it raises ImportError and never falls back
    to anything else
  * `resize_to_width`, `extract_frames`: width-400 frame JPEG dumps in the
    reference's folder layout (PIL, imported inside them)
  * `load_frame_folder`: a dumped folder back into [N, H, W, 3] uint8 (PIL)
  * `apply_attention`: the gaze-weighted frames of the attention variant,
    in torch on the frames' device, so the card needs no Pillow for it
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import log, mkdir_p

TARGET_WIDTH = 400  # extract_C3D_features.py:151


def _decoder_backend():
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        pass
    try:
        import imageio  # noqa: F401
    except ImportError:
        return None
    # imageio's plugin list names backends whether or not they are
    # installed: probe the packages themselves
    for backend in ("imageio_ffmpeg", "av"):
        try:
            __import__(backend)
            return "imageio"
        except ImportError:
            pass
    return None


def decode_video(path: str) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames [H, W, 3] from a video file."""
    backend = _decoder_backend()
    if backend == "cv2":
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[:, :, ::-1]  # BGR -> RGB
        finally:
            cap.release()
        return
    if backend == "imageio":
        import imageio

        for frame in imageio.imiter(path):
            yield np.asarray(frame)
        return
    raise ImportError(
        "no video decoder: install opencv-python, or imageio with "
        "imageio-ffmpeg or pyav, to decode video files")


def resize_to_width(frame: np.ndarray,
                    target_width: int = TARGET_WIDTH) -> np.ndarray:
    """Aspect-preserving resize to the reference's 400px extraction width."""
    from PIL import Image

    h, w = frame.shape[:2]
    if w == target_width:
        return frame
    target_height = int(round(h * target_width / w))
    img = Image.fromarray(frame).resize((target_width, target_height),
                                        Image.BILINEAR)
    return np.asarray(img)


def extract_frames(video_path: str, out_dir: str,
                   target_width: int = TARGET_WIDTH,
                   max_frames: Optional[int] = None) -> int:
    """Decode + resize + dump `%06d.jpg` frames; returns the frame count
    (`extract_frames`, extract_C3D_features.py:129-178)."""
    from PIL import Image

    mkdir_p(out_dir)
    count = 0
    for i, frame in enumerate(decode_video(video_path)):
        if max_frames is not None and i >= max_frames:
            break
        frame = resize_to_width(frame, target_width)
        Image.fromarray(frame).save(os.path.join(out_dir, f"{i:06d}.jpg"))
        count += 1
    log.info("extracted %d frames from %s", count, video_path)
    return count


def apply_attention(frames: torch.Tensor,
                    gazemaps: torch.Tensor) -> torch.Tensor:
    """Gaze-weighted frames: frame * gazemap resized to the frame size
    (`add_attention`, extract_C3D_features.py:739-761), on the frames'
    device.

    frames [N, H, W, 3] uint8 or float; gazemaps [N, GH, GW] in [0, 1].
    The map is resized in float (a uint8 map would zero probability maps,
    whose cells are ~1/2401) as PIL's float-mode BILINEAR resizes it:
    half-pixel centres and edge clamping when it grows, a triangle filter
    widened by the scale when it shrinks (`antialias=True` computes both),
    with the weights in float64 and the result rounded to float32, as PIL
    computes them. The f32 product is cast back to the frames' dtype,
    truncating as the JAX package's `astype` does.
    """
    h, w = frames.shape[1:3]
    maps = gazemaps.to(device=frames.device, dtype=torch.float64)
    maps = F.interpolate(maps[:, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0].float()
    return (frames.float() * maps[..., None]).to(frames.dtype)


def load_frame_folder(folder: str, image_hw: Optional[tuple[int, int]] = None,
                      backend: str = "pil") -> np.ndarray:
    """Read a dumped frame folder back into [N, H, W, 3] uint8 (PIL,
    BILINEAR when `image_hw` asks for a resize).

    backend="native" uses the threaded libjpeg batch decoder
    (`native/framedec.cc`) when `image_hw` is given and every file is a
    JPEG, and PIL otherwise or when the library cannot be built.
    Decode-only output is bit-identical to PIL; the native resize is
    half-pixel-centre bilinear (within a few steps of PIL.BILINEAR)."""
    if backend not in ("pil", "native"):
        raise ValueError(f"backend must be pil|native, got {backend!r}")
    files = sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not files:
        return np.zeros((0, 0, 0, 3), np.uint8)

    if backend == "native" and image_hw is not None and \
            all(f.lower().endswith((".jpg", ".jpeg")) for f in files):
        from .. import native

        if native.framedec_available():
            return native.decode_jpeg_batch(files, image_hw)

    from PIL import Image

    frames = []
    for path in files:
        img = Image.open(path).convert("RGB")
        if image_hw is not None and img.size != (image_hw[1], image_hw[0]):
            img = img.resize((image_hw[1], image_hw[0]), Image.BILINEAR)
        frames.append(np.asarray(img))
    return np.stack(frames)
