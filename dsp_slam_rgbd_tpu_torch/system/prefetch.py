"""Frames made one frame ahead of tracking on a thread of their own.

Counterpart of `dsp_slam_rgbd_tpu/system/prefetch.py`.  A background
thread reads the next frame's images, uploads them and (with
`FramePrefetcher`) runs the tracker's ORB extraction and stereo matching,
while the main thread tracks the current frame.

On the card the thread works on a CUDA stream of its own: images go up
from pinned host buffers without blocking (uint8 stays uint8 in flight;
the tracker casts on the device), and each item is handed over with an
event that the consuming thread's current stream waits on, its tensors
marked with `record_stream` for that stream, so the caching allocator
does not reuse their memory while the consumer's work is queued.  On the
CPU there is no stream and no event.

Usage::

    for frame in FramePrefetcher(tracker, seq_iter, sensor="stereo"):
        system.track_frame(frame, detections=...)
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.frontend.orb import upload

_END = object()


def tensors_of(obj):
    """Every tensor in a (nested) tuple, NamedTuple, list or dict."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from tensors_of(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors_of(x)


def record_on(obj, stream) -> None:
    """Mark every CUDA tensor of `obj` as used on `stream` (no-op without
    one): its memory is not reused before the stream's work queued so far
    has run."""
    if stream is None:
        return
    for t in tensors_of(obj):
        if t.is_cuda:
            t.record_stream(stream)


class _Ahead:
    """The producer thread, its stream and the bounded hand-over queue."""

    def __init__(self, device, source, depth: int):
        self._device = torch.device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(target=self._worker, args=(iter(source),), daemon=True,
                                        name="frame-prefetch")
        self._thread.start()

    def _make(self, i, item):
        raise NotImplementedError

    def _put(self, item) -> bool:
        # bounded put with a stop check: if the consumer abandons the
        # iteration, close() lets the thread end instead of blocking
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it):
        try:
            with torch.cuda.stream(self._stream):   # no-op on the CPU
                for i, item in enumerate(it):
                    made = self._make(i, item)
                    event = None
                    if self._stream is not None:
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    if not self._put((made, event)):
                        return
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._put(_END)  # never dropped while the consumer iterates

    def close(self):
        """Stop the thread and release buffered items (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is _END:
                    if self._err is not None:
                        raise self._err
                    return
                made, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(self._device)
                    cur.wait_event(event)
                    record_on(made, cur)
                yield made
        finally:
            self.close()


class ImagePrefetcher(_Ahead):
    """Upload each item's numpy arrays to `device` one item ahead; items are
    tuples (a bare array becomes a 1-tuple), other elements pass through."""

    def __init__(self, source, depth: int = 2, device="cuda"):
        super().__init__(device, source, depth)

    def _make(self, i, item):
        if not isinstance(item, tuple):
            item = (item,)
        return tuple(upload(x, self._device) if isinstance(x, np.ndarray) else x for x in item)


class FramePrefetcher(_Ahead):
    """Upload + ORB extraction (+ stereo matching) one frame ahead of
    tracking: the thread calls `tracker.make_frame` on each item, which
    reads only the tracker's configuration and device.

    `source` yields image tuples: (left, right) stereo, (img, depth) rgbd,
    (img,) mono.  Timestamps default to i / fps."""

    def __init__(self, tracker, source, sensor: str = "stereo", timestamps=None,
                 fps: float = 10.0, depth: int = 2):
        self._tracker = tracker
        self._sensor = sensor
        self._timestamps = timestamps
        self._fps = fps
        super().__init__(tracker.device, source, depth)

    def _make(self, i, item):
        if not isinstance(item, tuple):
            item = (item,)
        ts = self._timestamps[i] if self._timestamps is not None else i / self._fps
        if self._sensor == "stereo":
            return self._tracker.make_frame(item[0], img_right=item[1], timestamp=ts)
        if self._sensor == "rgbd":
            return self._tracker.make_frame(item[0], depth_map=item[1], timestamp=ts)
        return self._tracker.make_frame(item[0], timestamp=ts)
