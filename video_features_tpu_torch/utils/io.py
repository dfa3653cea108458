"""Host-side video decode for the port (the inline ``select`` path of
``video_features_tpu/utils/io.py``).

A streaming cv2 reader yields ``(frame_rgb_u8, timestamp_ms, index)``;
``fps=N`` resamples in-process with the timing rule of ffmpeg's ``fps``
filter (round=near) on bit-exact source frames; ``total=N`` derives the fps
that yields N frames. Iterating a :class:`VideoSource` batches its frames
(:func:`_batched`): ``batch_size`` frames, of which the first ``overlap``
are carried over from the batch before. ``cv2`` is imported only where a
file is decoded.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple, Union

import numpy as np


def get_video_props(path: Union[str, Path]) -> dict:
    """fps / num_frames / height / width via cv2."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    try:
        props = dict(
            fps=cap.get(cv2.CAP_PROP_FPS),
            num_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        )
    finally:
        cap.release()
    if not props["fps"] or props["fps"] <= 0:
        raise ValueError(f"Cannot determine fps of {path}")
    return props


def count_frames_by_decode(path: Union[str, Path]) -> int:
    """Exact frame count by decoding the stream once (for containers whose
    frame-count metadata is missing, before a resampling plan)."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = 0
    try:
        while cap.grab():
            n += 1
    finally:
        cap.release()
    return n


def fps_filter_map(num_frames: int, src_fps: float, dst_fps: float) -> np.ndarray:
    """Output -> source frame-index map of ffmpeg's ``fps=dst_fps`` filter:
    input frame i takes output slot ``floor(i * dst / src + 0.5)``, each
    slot holds the latest input frame at or before it, and the stream stops
    at ``round(num_frames * dst / src)`` frames (at least one)."""
    if num_frames <= 0:
        return np.zeros((0,), dtype=np.int64)
    r = dst_fps / src_fps
    slots = np.floor(np.arange(num_frames, dtype=np.float64) * r + 0.5
                     ).astype(np.int64)
    n_out = max(int(np.floor(num_frames * r + 0.5)), 1)
    src_of_slot = {int(s): idx for idx, s in enumerate(slots)}
    mapping = np.zeros((n_out,), dtype=np.int64)
    last = 0
    for k in range(n_out):
        last = src_of_slot.get(k, last)
        mapping[k] = last
    return mapping


def plan_frame_selection(src_fps: float, src_num_frames: int,
                         fps: Optional[float] = None,
                         total: Optional[int] = None,
                         ) -> Tuple[float, Optional[np.ndarray], int]:
    """``(out_fps, index_map_or_None, num_frames)`` for an ``fps`` /
    ``total`` request; ``None`` means every source frame."""
    if total is not None:
        fps = total * src_fps / max(src_num_frames, 1)
    if fps is not None:
        index_map = fps_filter_map(src_num_frames, src_fps, float(fps))
        if total is not None:
            index_map = index_map[:total]
        return float(fps), index_map, len(index_map)
    return float(src_fps), None, src_num_frames


#: what a decoded stream delivers: ``rgb`` (H, W, 3), or ``i420``, cv2's
#: ``COLOR_BGR2YUV_I420`` of the decoded frame, (H*3/2, W) packed planes
#: (the frame-wise families' raw wire under ``ingest=yuv420``)
CHANNEL_ORDERS = ("rgb", "i420")


class _FrameStream:
    """Sequential cv2 decoder (``channel_order`` out) with the reference's
    retry of a missing frame #0 (reference utils/io.py:99-106)."""

    def __init__(self, path: str, channel_order: str = "rgb"):
        import cv2
        if channel_order not in CHANNEL_ORDERS:
            raise ValueError(f"channel_order={channel_order!r}: expected "
                             f"one of {CHANNEL_ORDERS}")
        self._cv2 = cv2
        self._code = (cv2.COLOR_BGR2RGB if channel_order == "rgb"
                      else cv2.COLOR_BGR2YUV_I420)
        self.cap = cv2.VideoCapture(path)
        self._first = True

    def _next(self, grab_only: bool):
        ok = self.cap.grab()
        if not ok and self._first:
            print("Detect missing frame")
            ok = self.cap.grab()
        self._first = False
        if not ok:
            return None
        if grab_only:
            return True
        ok, frame = self.cap.retrieve()
        return self._cv2.cvtColor(frame, self._code) if ok else None

    def read(self) -> Optional[np.ndarray]:
        return self._next(False)

    def skip(self) -> bool:
        """Advance one frame without converting it (a frame the fps filter
        drops pays decode only)."""
        return self._next(True) is not None

    def release(self) -> None:
        self.cap.release()


class VideoSource:
    """Frames of one video, resampled to ``fps`` or ``total`` frames,
    decoded as ``channel_order`` (``rgb`` or ``i420``) and passed through
    ``transform``; iterating it yields batches ``(frames, timestamps_ms,
    indices)`` of ``batch_size`` frames with ``overlap`` frames carried
    between consecutive batches."""

    def __init__(self, path: Union[str, Path], fps: Optional[float] = None,
                 total: Optional[int] = None, batch_size: int = 1,
                 transform: Optional[Callable[[np.ndarray],
                                              np.ndarray]] = None,
                 overlap: int = 0, channel_order: str = "rgb"):
        if fps is not None and total is not None:
            raise ValueError("'fps' and 'total' are mutually exclusive")
        if not (isinstance(batch_size, int) and batch_size > 0
                and isinstance(overlap, int) and 0 <= overlap < batch_size):
            raise ValueError(f"batch_size={batch_size!r}, overlap={overlap!r}:"
                             " need 0 <= overlap < batch_size")
        self.path = str(path)
        self.channel_order = channel_order
        self.batch_size = batch_size
        self.transform = transform
        self.overlap = overlap
        props = get_video_props(self.path)
        self.src_fps = props["fps"]
        self.src_num_frames = props["num_frames"]
        if (fps is not None or total is not None) and self.src_num_frames <= 0:
            self.src_num_frames = count_frames_by_decode(self.path)
            if self.src_num_frames == 0:
                raise ValueError(f"No decodable frames in {self.path}")
        self.fps, self.index_map, self.num_frames = plan_frame_selection(
            self.src_fps, self.src_num_frames, fps=fps, total=total)

    def frames(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        """Yield ``(frame, timestamp_ms, out_index)`` in order,
        ``timestamp_ms = out_index / fps * 1000``, the frame through
        ``transform`` when one is set."""
        if self.transform is None:
            return self._decoded()
        return ((self.transform(f), t, i) for f, t, i in self._decoded())

    def __iter__(self) -> Iterator[Tuple[List, List[float], List[int]]]:
        return _batched(self.frames(), self.batch_size, self.overlap)

    def _decoded(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        stream = _FrameStream(self.path, self.channel_order)
        try:
            if self.index_map is None:
                out_idx = 0
                while True:
                    rgb = stream.read()
                    if rgb is None:
                        return
                    yield rgb, out_idx / self.fps * 1000.0, out_idx
                    out_idx += 1
            src_idx = -1
            current = None
            for out_idx, want in enumerate(self.index_map):
                while src_idx < want:
                    if src_idx < want - 1:
                        ok = stream.skip()
                    else:
                        current = stream.read()
                        ok = current is not None
                    if not ok:
                        print(f"Warning: {self.path} ended after "
                              f"{src_idx + 1} frames (metadata said "
                              f"{self.src_num_frames}); emitted "
                              f"{out_idx}/{len(self.index_map)} "
                              "resampled frames.")
                        return
                    src_idx += 1
                yield current, out_idx / self.fps * 1000.0, out_idx
        finally:
            stream.release()


def _batched(frames: Iterator[Tuple[np.ndarray, float, int]],
             batch_size: int, overlap: int
             ) -> Iterator[Tuple[List, List[float], List[int]]]:
    """Batch a ``frames()`` stream (the JAX ``_batched``): a batch is
    emitted when it holds ``batch_size`` frames, and its last ``overlap``
    frames open the next one. The last batch may be short, but a batch of
    only carried-over frames is never emitted."""
    batch: List = []
    times: List[float] = []
    indices: List[int] = []
    fresh = 0  # frames added since the last yield (excludes the overlap)
    for x, ts, idx in frames:
        batch.append(x)
        times.append(ts)
        indices.append(idx)
        fresh += 1
        if len(batch) == batch_size:
            yield batch, times, indices
            keep = len(batch) - overlap
            batch, times, indices = (batch[keep:], times[keep:],
                                     indices[keep:])
            fresh = 0
    if fresh > 0:
        yield batch, times, indices


class Prefetcher:
    """Decode-ahead iterator: runs ``iterable`` on a background thread into
    a bounded queue so host decode overlaps device compute. Producer
    exceptions re-raise in the consumer; an abandoned consumer stops the
    producer at its next bounded put."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self.iterable:
                    if not put(item):
                        return
                put(self._DONE)
            except BaseException as e:  # re-raised on the consumer side
                put(e)

        t = threading.Thread(target=produce, name="vft-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
