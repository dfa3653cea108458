"""Host-side video decode for the port (the ``select`` decode paths of
``video_features_tpu/utils/io.py``).

A streaming cv2 reader yields ``(frame_rgb_u8, timestamp_ms, index)``;
``fps=N`` resamples in-process with the timing rule of ffmpeg's ``fps``
filter (round=near) on bit-exact source frames; ``total=N`` derives the fps
that yields N frames. Iterating a source batches its frames
(:func:`_batched`): ``batch_size`` frames, of which the first ``overlap``
are carried over from the batch before. Three sources with one surface
(``fps``, ``num_frames``, ``height``, ``width``, ``len``, ``frames()``,
batched iteration, ``cancel``, ``release``), chosen by ``video_decode``:

  - :class:`VideoSource` (``inline``): decode on the calling thread;
  - :class:`ProcessVideoSource` (``process``): decode and the host
    transform in one spawned process, frames back through a bounded queue;
  - :class:`ParallelVideoSource` (``parallel``): the output frame range cut
    into ``decode_workers`` contiguous segments, each decoded by its own
    spawned process from a seek to its first source frame; the parent
    concatenates them in order, frame for frame what :class:`VideoSource`
    gives.

``cancel`` is thread-safe (the deadline watchdog of ``utils/faults.py``):
it releases the capture, or terminates the worker processes, and the
consuming ``frames()`` raises ``DeadlineExceeded``. The spawned children
import this module and numpy (cv2 where they decode, and whatever the
transform they are sent needs), never the models or the card. ``cv2`` is
imported only where a file is decoded. ``_FrameStream.read`` hosts the
``decode.read`` injection site (``utils/inject.py``).

Every read, grab-only skip and host transform of :class:`VideoSource` is a
``decode`` profiler stage (``utils/profiling.py``), and the decode-ahead
:class:`Prefetcher` carries the consumer's telemetry span onto its thread;
the spawned sources decode in children, whose stages the parent does not
see.
"""
from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..telemetry import trace
from ..telemetry.spans import current_span, use_span
from . import inject
from .faults import DeadlineExceeded
from .profiling import profiler


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

_decoded_lock = threading.Lock()
_decoded = 0


def decoded_frames() -> int:
    """Source frames this process has decoded so far (every grab of every
    :class:`_FrameStream`: the frames read and the frames skipped)."""
    return _decoded


def _count_decoded() -> None:
    global _decoded
    with _decoded_lock:
        _decoded += 1


def convert_decoded(frame_bgr: np.ndarray,
                    channel_order: Optional[str]) -> np.ndarray:
    """A decoder-native BGR frame as ``channel_order`` (None: as it is):
    the one conversion of every decode path, so the shared decode
    (``parallel/fanout.py``) and a private source cannot drift."""
    if channel_order is None:
        return frame_bgr
    import cv2
    code = (cv2.COLOR_BGR2RGB if channel_order == "rgb"
            else cv2.COLOR_BGR2YUV_I420)
    return cv2.cvtColor(frame_bgr, code)


class _FrameStream:
    """Sequential cv2 decoder (``channel_order`` out, or with None the
    decoder's own BGR frames, for the shared decode) with the reference's
    retry of a missing frame #0 (reference utils/io.py:99-106).

    ``start > 0`` seeks to that source frame first (frame-accurate on the
    ffmpeg backend, which decodes forward from the keyframe before it); a
    seek the capture does not confirm falls back to frame 0 with a warning
    (``self.start`` says where the stream stands). ``release`` may be
    called from another thread (the deadline watchdog): it drops the
    capture, and the next read or skip returns as at the end of the
    stream. It first waits up to :data:`RELEASE_GRACE_S` for a read in
    flight to return, since freeing a capture under a running cv2 call can
    crash the process; a read stuck longer is released under it, as the
    JAX package does, to unblock it."""

    #: how long ``release`` waits for a cv2 call in flight
    RELEASE_GRACE_S = 1.0

    def __init__(self, path: str, channel_order: Optional[str] = "rgb",
                 start: int = 0):
        import cv2
        if channel_order is not None and channel_order not in CHANNEL_ORDERS:
            raise ValueError(f"channel_order={channel_order!r}: expected "
                             f"one of {CHANNEL_ORDERS}")
        self._order = channel_order
        self._path = str(path)
        self.cap = cv2.VideoCapture(self._path)
        self._busy = threading.Lock()  # held while a cv2 call runs
        self._first = True
        self.start = 0
        if start > 0:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            got = self.cap.get(cv2.CAP_PROP_POS_FRAMES)
            if int(round(got)) == start:
                self.start = start
                self._first = False  # the frame-0 retry is for frame 0
            else:
                print(f"WARNING: seek verification failed for {path} "
                      f"(wanted frame {start}, CAP_PROP_POS_FRAMES={got}); "
                      "decoding this segment from frame 0 (video_decode="
                      "parallel assumes constant-rate seekable input)")
                self.cap.release()
                self.cap = cv2.VideoCapture(self._path)
        # the armed plan, read once per stream
        self._inject = inject.active()

    def _next(self, grab_only: bool):
        with self._busy:
            cap = self.cap  # a concurrent release() sets self.cap to None
            if cap is None:
                return None
            ok = cap.grab()
            if not ok and self._first:
                print("Detect missing frame")
                ok = cap.grab()
            self._first = False
            if not ok:
                return None
            _count_decoded()
            if grab_only:
                return True
            ok, frame = cap.retrieve()
        return convert_decoded(frame, self._order) if ok else None

    def read(self) -> Optional[np.ndarray]:
        if self._inject is not None:
            self._inject.check("decode.read", {"video": self._path})
        return self._next(False)

    def skip(self) -> bool:
        """Advance one frame without converting it (a frame the fps filter
        drops pays decode only)."""
        return self._next(True) is not None

    def release(self) -> None:
        idle = self._busy.acquire(timeout=self.RELEASE_GRACE_S)
        try:
            cap, self.cap = self.cap, None
            if cap is not None:
                cap.release()
        finally:
            if idle:
                self._busy.release()


def _select(stream: _FrameStream, src_indices: Sequence[int],
            ) -> Iterator[np.ndarray]:
    """The frames of ``stream`` at the ascending source indices
    ``src_indices`` (repeats allowed), the skipped ones grabbed only; stops
    early where the stream ends."""
    pos = stream.start - 1
    current = None
    for want in src_indices:
        while pos < want:
            if pos < want - 1:
                with profiler.stage("decode"):
                    ok = stream.skip()
            else:
                with profiler.stage("decode"):
                    current = stream.read()
                ok = current is not None
            if not ok:
                return
            pos += 1
        yield current


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
        self._cancel_reason: Optional[str] = None
        self._stream: Optional[_FrameStream] = None
        self._lock = threading.Lock()
        props = get_video_props(self.path)
        self.src_fps = props["fps"]
        self.src_num_frames = props["num_frames"]
        self.height, self.width = props["height"], props["width"]
        if (fps is not None or total is not None) and self.src_num_frames <= 0:
            self.src_num_frames = count_frames_by_decode(self.path)
            if self.src_num_frames == 0:
                raise ValueError(f"No decodable frames in {self.path}")
        self.fps, self.index_map, self.num_frames = plan_frame_selection(
            self.src_fps, self.src_num_frames, fps=fps, total=total)

    def __len__(self) -> int:
        return self.num_frames

    def cancel(self, reason: str = "cancelled") -> None:
        """Thread-safe kill of the in-flight decode: release the active
        stream, so a read blocked in cv2 returns, and make ``frames()``
        raise ``DeadlineExceeded`` instead of ending short."""
        with self._lock:
            self._cancel_reason = reason or "cancelled"
            stream = self._stream
        if stream is not None:
            stream.release()

    release = cancel

    def _raise_if_cancelled(self) -> None:
        if self._cancel_reason is not None:
            raise DeadlineExceeded(f"{self.path}: {self._cancel_reason}")

    def frames(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        """Yield ``(frame, timestamp_ms, out_index)`` in order,
        ``timestamp_ms = out_index / fps * 1000``, the frame through
        ``transform`` when one is set."""
        if self.transform is None:
            return self._decoded()
        return self._transformed(self.transform)

    def _transformed(self, tf: Callable[[np.ndarray], np.ndarray]
                     ) -> Iterator[Tuple[np.ndarray, float, int]]:
        for frame, t, i in self._decoded():
            with profiler.stage("decode"):
                x = tf(frame)
            yield x, t, i

    def __iter__(self) -> Iterator[Tuple[List, List[float], List[int]]]:
        return _batched(self.frames(), self.batch_size, self.overlap)

    def _decoded(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        stream = _FrameStream(self.path, self.channel_order)
        with self._lock:
            self._stream = stream
        try:
            # after registering: a cancel() before it is not lost
            self._raise_if_cancelled()
            if self.index_map is None:
                out_idx = 0
                while True:
                    with profiler.stage("decode"):
                        rgb = stream.read()
                    if rgb is None:
                        # a released stream ends like EOF: tell them apart
                        self._raise_if_cancelled()
                        return
                    yield rgb, out_idx / self.fps * 1000.0, out_idx
                    out_idx += 1
                    self._raise_if_cancelled()
            out_idx = 0
            for current in _select(stream, self.index_map):
                yield current, out_idx / self.fps * 1000.0, out_idx
                out_idx += 1
                self._raise_if_cancelled()
            self._raise_if_cancelled()
            if out_idx < len(self.index_map):
                print(f"Warning: {self.path} ended before its metadata's "
                      f"{self.src_num_frames} frames; emitted "
                      f"{out_idx}/{len(self.index_map)} resampled frames.")
        finally:
            with self._lock:
                self._stream = None
            stream.release()


def _decode_worker(q, path: str, kwargs: dict) -> None:
    """:class:`ProcessVideoSource`'s child: a :class:`VideoSource` with the
    parent's arguments; protocol ``('props', {...})``, ``('frame', (x, t,
    i))``*, then ``('done', None)`` or ``('error', "Type: message")``."""
    try:
        src = VideoSource(path, **kwargs)
        q.put(("props", {"fps": src.fps, "src_fps": src.src_fps,
                         "num_frames": src.num_frames,
                         "src_num_frames": src.src_num_frames,
                         "height": src.height, "width": src.width}))
        for item in src.frames():
            q.put(("frame", item))
        q.put(("done", None))
    except BaseException as e:
        try:
            q.put(("error", f"{type(e).__name__}: {e}"))
        except Exception:
            pass


class _WorkerQueue:
    """The parent's end of one decode child: its queue and process, polled
    once a second so a cancel or a child killed from outside is noticed."""

    def __init__(self, ctx, target, args: tuple, maxsize: int) -> None:
        self.q = ctx.Queue(maxsize=maxsize)
        self.proc = ctx.Process(target=target, args=(self.q,) + args,
                                daemon=True)
        self.proc.start()

    def get(self, path: str, raise_if_cancelled: Callable[[], None]):
        """The child's next ``(tag, payload)``; ``RuntimeError`` when it
        died without one or reported an error."""
        while True:
            raise_if_cancelled()
            try:
                tag, payload = self.q.get(timeout=1.0)
            except queue.Empty:
                if self.proc.is_alive():
                    continue
                raise_if_cancelled()  # the watchdog terminated it
                try:  # it may have flushed its tail and exited just now
                    tag, payload = self.q.get_nowait()
                except queue.Empty:
                    raise RuntimeError(
                        f"decode worker for {path} died without a result "
                        f"(killed? exitcode={self.proc.exitcode})") from None
            if tag == "error":
                raise RuntimeError(
                    f"decode worker failed for {path}: {payload}")
            return tag, payload

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        # join a cleanly exited child too, or it stays a zombie
        self.proc.join(timeout=10)


class _SpawnedSource:
    """What the process and parallel sources share: cancellation, teardown
    of their children, length and batched iteration."""

    path: str
    batch_size: int
    overlap: int
    num_frames: int

    def _init_workers(self) -> None:
        self._cancel_reason: Optional[str] = None
        self._workers: List[_WorkerQueue] = []
        self._release_lock = threading.Lock()

    def __len__(self) -> int:
        return self.num_frames

    def __iter__(self) -> Iterator[Tuple[List, List[float], List[int]]]:
        return _batched(self.frames(), self.batch_size, self.overlap)

    def _raise_if_cancelled(self) -> None:
        if self._cancel_reason is not None:
            raise DeadlineExceeded(f"{self.path}: {self._cancel_reason}")

    def cancel(self, reason: str = "cancelled") -> None:
        """Thread-safe kill: terminate the children; the consuming thread
        raises ``DeadlineExceeded`` at its next poll."""
        self._cancel_reason = reason or "cancelled"
        self.release()

    def release(self) -> None:
        """Stop every child; a second caller (the consumer while the
        watchdog stops them) waits until they are gone."""
        with self._release_lock:
            for w in self._workers:
                w.stop()

    def __del__(self):  # abandoned mid-video: do not leak the children
        try:
            self.release()
        except Exception:
            pass


class ProcessVideoSource(_SpawnedSource):
    """:class:`VideoSource` whose decode and ``transform`` run in one
    spawned process (``video_decode=process``), so the host transform's
    numpy and PIL work leaves the parent's interpreter lock. Spawning costs
    a second or two a video. ``transform`` must pickle (every family's host
    transform does, ``ops/host_transforms.py``)."""

    #: frames the child may queue ahead, and how long its first message
    #: (the video's properties) may take
    DEPTH, START_TIMEOUT_S = 16, 120.0

    def __init__(self, path: Union[str, Path], fps: Optional[float] = None,
                 total: Optional[int] = None, batch_size: int = 1,
                 transform: Optional[Callable] = None, overlap: int = 0,
                 channel_order: str = "rgb"):
        import multiprocessing as mp
        self.path = str(path)
        self.batch_size = batch_size
        self.overlap = overlap
        self._init_workers()
        self._workers.append(_WorkerQueue(
            mp.get_context("spawn"), _decode_worker,
            (self.path, dict(fps=fps, total=total, transform=transform,
                             channel_order=channel_order)),
            self.DEPTH))
        worker = self._workers[0]
        try:
            tag, props = worker.q.get(timeout=self.START_TIMEOUT_S)
        except BaseException:
            self.release()
            raise
        if tag != "props":
            self.release()
            raise RuntimeError(f"decode worker failed for {self.path}: "
                               f"{props}")
        self.fps = props["fps"]
        self.src_fps = props["src_fps"]
        self.num_frames = props["num_frames"]
        self.src_num_frames = props["src_num_frames"]
        self.height, self.width = props["height"], props["width"]
        self._worker = worker

    def frames(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        try:
            while True:
                tag, payload = self._worker.get(self.path,
                                                self._raise_if_cancelled)
                if tag == "done":
                    return
                yield payload
        finally:
            self.release()


def _segment_decode_worker(q, path: str, seg: dict) -> None:
    """:class:`ParallelVideoSource`'s child: decode one contiguous segment
    of the output range, from a seek to its first source frame, and ship
    its frames; protocol ``('frame', (x, t, i))``* then ``('done',
    n_emitted)``, or ``('error', "Type: message")``."""
    try:
        transform = seg["transform"]
        fps, out_start = seg["fps"], seg["out_start"]
        src_indices = seg["src_indices"]
        stream = _FrameStream(path, seg["channel_order"],
                              start=int(src_indices[0]))
        emitted = 0
        try:
            for frame in _select(stream, src_indices):
                out_idx = out_start + emitted
                x = transform(frame) if transform is not None else frame
                q.put(("frame", (x, out_idx / fps * 1000.0, out_idx)))
                emitted += 1
        finally:
            stream.release()
        q.put(("done", emitted))
    except BaseException as e:
        try:
            q.put(("error", f"{type(e).__name__}: {e}"))
        except Exception:
            pass


class ParallelVideoSource(_SpawnedSource):
    """One video's output frame range cut into ``decode_workers``
    contiguous segments, each decoded by its own spawned process from a
    seek to its first source frame, replaying the same frame walk as
    :class:`VideoSource` (``video_decode=parallel``); the parent reads the
    segments in order, so the stream is :class:`VideoSource`'s frame for
    frame. A stream that ends inside a segment truncates there, as the
    serial path does. Where the metadata reports no frames and every
    source frame is wanted, the frames are counted by decode first (the
    JAX source gives an empty stream there). ``transform`` must pickle."""

    def __init__(self, path: Union[str, Path], fps: Optional[float] = None,
                 total: Optional[int] = None, batch_size: int = 1,
                 transform: Optional[Callable] = None, overlap: int = 0,
                 channel_order: str = "rgb", decode_workers: int = 2,
                 depth: Optional[int] = None):
        import multiprocessing as mp
        if not (isinstance(decode_workers, int) and decode_workers >= 1):
            raise ValueError(f"decode_workers={decode_workers!r}: need an "
                             "int >= 1")
        self.path = str(path)
        self.batch_size = batch_size
        self.overlap = overlap
        self._init_workers()
        probe = VideoSource(self.path, fps=fps, total=total,
                            batch_size=batch_size, overlap=overlap,
                            channel_order=channel_order)
        self.fps = probe.fps
        self.src_fps = probe.src_fps
        self.num_frames = probe.num_frames
        self.src_num_frames = probe.src_num_frames
        self.height, self.width = probe.height, probe.width
        if probe.index_map is None and probe.num_frames <= 0:
            n = count_frames_by_decode(self.path)
            if n == 0:
                raise ValueError(f"No decodable frames in {self.path}")
            print(f"Warning: {self.path} metadata reported "
                  f"{probe.num_frames} frames; counted {n} by decode.")
            self.num_frames = self.src_num_frames = n
        index_map = (probe.index_map if probe.index_map is not None
                     else np.arange(self.num_frames, dtype=np.int64))
        m = len(index_map)
        n = max(1, min(decode_workers, m)) if m else 1
        bounds = [round(i * m / n) for i in range(n + 1)]
        ctx = mp.get_context("spawn")
        self._expected: List[int] = []
        for o0, o1 in zip(bounds, bounds[1:]):
            if o1 <= o0:
                continue
            # a whole segment of transformed (small) frames may wait in its
            # queue, so every child decodes at once; raw full-size frames
            # are bounded to 64 a child; ``depth`` overrides both
            if depth is not None:
                qsize = max(int(depth), 2)
            elif transform is not None:
                qsize = o1 - o0 + 1
            else:
                qsize = 64
            seg = dict(src_indices=index_map[o0:o1], out_start=o0,
                       fps=self.fps, transform=transform,
                       channel_order=channel_order)
            self._workers.append(_WorkerQueue(ctx, _segment_decode_worker,
                                              (self.path, seg), qsize))
            self._expected.append(o1 - o0)

    def frames(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        segments = list(zip(self._workers, self._expected))
        try:
            for worker, expected in segments:
                while True:
                    tag, payload = worker.get(self.path,
                                              self._raise_if_cancelled)
                    if tag == "done":
                        break
                    yield payload
                if payload < expected:
                    print(f"Warning: {self.path} ended early; segment "
                          f"emitted {payload}/{expected} frames, "
                          "truncating (the metadata overstated the count).")
                    return
        finally:
            self.release()


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
    producer at its next bounded put. The producer runs under the telemetry
    span of the thread that built the prefetcher, so its ``decode`` stages
    attribute to that video; with ``trace=true`` each pull is a
    ``prefetch.next`` span and each put that waited a ``prefetch.put_blocked``
    one."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth
        self._span = current_span()

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
                with use_span(self._span):
                    it = iter(self.iterable)
                    while True:
                        tr = trace.active()
                        t0 = time.perf_counter() if tr is not None else 0.0
                        try:
                            item = next(it)
                        except StopIteration:
                            break
                        if tr is not None:
                            tr.complete("prefetch.next", t0,
                                        time.perf_counter() - t0)
                        t1 = time.perf_counter()
                        if not put(item):
                            return
                        if tr is not None:
                            # a put that waited: the consumer (the card)
                            # fell behind
                            blocked = time.perf_counter() - t1
                            if blocked >= trace.STALL_MIN_S:
                                tr.complete("prefetch.put_blocked", t1,
                                            blocked)
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


def which_ffmpeg() -> str:
    """Path to the ffmpeg binary, or '' (reference utils/utils.py:170-183)."""
    import shutil
    return shutil.which("ffmpeg") or ""


def extract_wav_from_mp4(video_path: Union[str, Path],
                         tmp_path: Union[str, Path]) -> Tuple[str, str]:
    """mp4 -> .aac (codec copy) -> .wav by two ffmpeg calls, written into
    ``tmp_path`` (reference utils/utils.py:186-215: an mp4's audio cannot be
    converted to wav directly with ``-acodec copy``). Returns ``(wav,
    aac)``. There is no in-process AAC decoder, so this needs the ffmpeg
    binary and raises ``RuntimeError`` without it."""
    import subprocess

    ffmpeg = which_ffmpeg()
    if not ffmpeg:
        raise RuntimeError(
            "ffmpeg is required to rip audio from .mp4 (reference "
            "utils/utils.py:197); install it or pass a .wav file directly")
    video_path = str(video_path)
    if not video_path.endswith(".mp4"):
        raise ValueError(f"expected an .mp4 file, got {video_path}")
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    stem = Path(video_path).stem
    aac = str(tmp / f"{stem}.aac")
    wav = str(tmp / f"{stem}.wav")
    with trace.span("wav_rip", video=video_path):
        for cmd in (
            [ffmpeg, "-hide_banner", "-loglevel", "panic", "-y", "-i",
             video_path, "-acodec", "copy", aac],
            [ffmpeg, "-hide_banner", "-loglevel", "panic", "-y", "-i", aac,
             wav],
        ):
            subprocess.run(cmd, check=True)
    return wav, aac
