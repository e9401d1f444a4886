"""The served video's upload to the card through page-locked staging on a
copy stream, so that one caller's upload runs on the copy engine while
another caller's tower runs on the SMs.

A pageable `tensor.to(device)` copies on the caller's current stream and
then waits for that stream: two callers that share a stream take turns,
copy, tower, copy, tower, and the link runs at the pageable rate. Here a
request in host memory is copied, one video at a time, into the pinned
buffer of an upload lane, and each video's bytes go to the card
`non_blocking` on the lane's own stream as soon as they are staged, so
the host's copy of video k+1 overlaps the DMA of video k. The caller's
current stream waits on an event recorded after the last chunk; the host
never waits on the compute stream. The bytes go as they are: nothing is
widened or cropped on the host.

`stage_to_device` takes the lane path when the device is a card and the
input lies in host memory (a numpy array or a CPU tensor); a CPU device,
or an input already on a card, takes a direct `.to(device)`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch


class Lane:
    """A page-locked host buffer, sized to the largest request the lane has
    carried, the stream its copies run on, and the event recorded after
    its last copy out of the buffer. On a CPU device the buffer is plain
    memory and there is no stream (the tests' lanes)."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.buffer = torch.empty(0, dtype=torch.uint8, pin_memory=cuda)
        self.done = None

    def staging(self, nbytes: int) -> torch.Tensor:
        """The first `nbytes` of the buffer, once the lane's previous copies
        out of it have finished; regrown only for a larger request."""
        if self.done is not None:
            self.done.synchronize()
        if self.buffer.numel() < nbytes:
            self.buffer = torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=self.stream is not None)
        return self.buffer[:nbytes]


class LanePool:
    """Upload lanes, checked out by one call at a time and returned when it
    ends: the pool holds as many lanes as calls have been concurrent, so
    its pinned memory is one request's size per concurrent caller. Lanes
    are not keyed by thread, so a pool of threads cannot leak them."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.lanes: list = []      # every lane made, for the tests
        self._free: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def checkout(self) -> Iterator[Lane]:
        with self._lock:
            lane = self._free.pop() if self._free else None
        if lane is None:
            lane = Lane(self.device)
            with self._lock:
                self.lanes.append(lane)
        try:
            yield lane
        finally:
            with self._lock:
                self._free.append(lane)


def chunk_plan(nbytes: int, rows: int) -> list:
    """The byte ranges [start, stop) in which a request of `rows` equal rows
    (videos) and `nbytes` bytes is staged, in order: one row each."""
    if nbytes == 0:
        return []
    step = nbytes // rows if rows > 1 else nbytes
    return [(start, min(start + step, nbytes))
            for start in range(0, nbytes, step)]


def stage_to_device(video, device: torch.device, pool: LanePool
                    ) -> tuple[torch.Tensor, int]:
    """`video` on `device` in its own dtype, and the bytes staged through a
    lane (0 where it went directly). The caller's current stream may use
    the result at once: it waits on the lane's copies."""
    host = torch.as_tensor(video)
    if device.type != "cuda" or host.device.type != "cpu":
        return host.to(device), 0
    host = host.contiguous()
    src = host.reshape(-1).view(torch.uint8)
    compute = torch.cuda.current_stream(device)
    with pool.checkout() as lane:
        staged = lane.staging(src.numel())
        with torch.cuda.stream(lane.stream):
            out = torch.empty(host.shape, dtype=host.dtype, device=device)
            dst = out.reshape(-1).view(torch.uint8)
            for start, stop in chunk_plan(src.numel(),
                                          host.shape[0] if host.dim() else 1):
                staged[start:stop].copy_(src[start:stop])
                dst[start:stop].copy_(staged[start:stop], non_blocking=True)
            lane.done = torch.cuda.Event()
            lane.done.record(lane.stream)
        compute.wait_event(lane.done)
        out.record_stream(compute)
    return out, src.numel()
