"""Video decoding for the raw-video pipeline: the port's copy of
`decode_video` from the JAX package's `data/video.py` (the frame-dump and
attention helpers there are not ported yet, ROADMAP.md queue A item 7).

cv2 decodes when it imports, then imageio with an ffmpeg or pyav backend.
With neither, `decode_video` raises ImportError; it never falls back to
anything else.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
