"""Shared decode: one decode pass of a video feeds every family of a
multi-family run (port of ``video_features_tpu/parallel/fanout.py``).

  :class:`FrameBus`
      One video's single decoder (``utils/io.py _FrameStream``, with the
      missing-frame-0 retry and the grab-only skip of the private sources)
      walking the union of its subscribers' frame plans. Each plan is
      ``plan_frame_selection``'s, as a private ``VideoSource`` computes it,
      so a source frame that any family needs is decoded once and each
      family gets the frames, timestamps and indices its own source would
      have given. Frames decode as BGR; each delivery order (``rgb``,
      ``i420``) is converted at most once per frame, however many families
      want it (``utils/io.py convert_decoded``, the private sources' own
      conversion).

  :class:`SharedFrameSource`
      A subscriber's end of the bus, with ``VideoSource``'s surface
      (``fps``, ``num_frames``, ``len``, ``frames()``, batched iteration,
      thread-safe ``cancel``). It draws frames from a bounded queue (the
      decoder blocks when a family falls ``depth`` frames behind) and
      applies the family's host transform on the family's side. A closed
      or cancelled subscriber is skipped by the bus, so one family's
      failure never stalls its siblings.

  :class:`SharedDecodeSession`
      The per-video umbrella a ``MultiExtractor`` installs on each family's
      thread (:func:`use_session`): visual families reach the bus through
      ``BaseExtractor.video_source``, audio families share one wav rip
      (:meth:`SharedDecodeSession.shared_wav`).

Subscription: the bus knows the families it expects; each one either
subscribes (blocking until every expected family has arrived, then getting
a probed source) or is marked ``done`` (skipped, served from the cache,
failed before decoding); decode starts once all have arrived. A retry
after a mid-stream failure gets ``None`` from ``subscribe`` (the one pass
has flowed) and decodes privately. ``_FrameStream.read`` fires the
``decode.read`` injection site here as on every decode path.

Telemetry (no-ops when off): the bus's reads, grabs and conversions and
each family's transform are ``decode`` profiler stages; a put that found a
family's queue full is ``vft_fanout_put_blocked_ms_total{family}`` (the
family is the slow consumer), a family's wait on an empty queue
``vft_fanout_get_starved_ms_total{family}`` (decode is the wall), with the
queue depth as ``vft_fanout_queue_depth{family}``; a failed pass counts
``vft_fanout_decode_errors_total``. With ``trace=true`` the stalls past
``trace.STALL_MIN_S``, the arrival barrier, the whole pass
(``fanout.decode_pass``) and the shared rip (``wav_rip``) are spans.
Each subscription records the decode milliseconds the bus had spent when
its stream completed (``decode_shared_ms``, the family span's field).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..telemetry import trace
from ..utils import faults
from ..utils.faults import DeadlineExceeded
from ..utils.profiling import profiler
from ..utils.io import (CHANNEL_ORDERS, _batched, _FrameStream,
                        convert_decoded, count_frames_by_decode,
                        get_video_props, plan_frame_selection)

#: default per-subscriber queue depth in decoded frames (a 320x240 RGB
#: frame is 230 KB, so about 15 MB a family)
DEFAULT_DEPTH = 64

_tls = threading.local()


def current_session() -> Optional["SharedDecodeSession"]:
    """The shared-decode session installed on this thread, if any."""
    return getattr(_tls, "session", None)


@contextmanager
def use_session(session: Optional["SharedDecodeSession"]) -> Iterator[None]:
    """Install ``session`` on this thread for a block."""
    prev = getattr(_tls, "session", None)
    _tls.session = session
    try:
        yield
    finally:
        _tls.session = prev


class SharedFrameSource:
    """One family's subscription, with ``VideoSource``'s surface; the bus
    fills in the plan (``fps``, ``index_map``, ``num_frames``, the source
    properties) before ``subscribe`` returns it."""

    def __init__(self, bus: "FrameBus", family: str, *, batch_size: int = 1,
                 fps: Optional[float] = None, total: Optional[int] = None,
                 transform: Optional[Callable] = None, overlap: int = 0,
                 channel_order: str = "rgb", depth: int = DEFAULT_DEPTH):
        if not (isinstance(batch_size, int) and batch_size > 0
                and isinstance(overlap, int) and 0 <= overlap < batch_size):
            raise ValueError(f"batch_size={batch_size!r}, overlap={overlap!r}:"
                             " need 0 <= overlap < batch_size")
        if channel_order not in CHANNEL_ORDERS:
            raise ValueError(f"channel_order={channel_order!r}: expected "
                             f"one of {CHANNEL_ORDERS}")
        if fps is not None and total is not None:
            raise ValueError("'fps' and 'total' are mutually exclusive")
        self.bus = bus
        self.family = str(family)
        self.path = bus.path
        self.batch_size = batch_size
        self.overlap = overlap
        self.transform = transform
        self.channel_order = channel_order
        self._want_fps = None if fps is None else float(fps)
        self._want_total = None if total is None else int(total)
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 2))
        self.closed = False
        self._cancelled = False
        self._cancel_reason = ""
        self._error: Optional[str] = None
        #: ms of the bus's decode that had run when this stream completed
        self.decode_shared_ms: Optional[float] = None
        self.fps: float = 0.0
        self.index_map: Optional[np.ndarray] = None
        self.num_frames: int = 0
        self.src_fps: float = 0.0
        self.src_num_frames: int = 0
        self.height = self.width = 0

    # -- bus side -----------------------------------------------------------
    def _set_plan(self, src_fps: float, src_num_frames: int, height: int,
                  width: int) -> None:
        self.src_fps, self.src_num_frames = src_fps, src_num_frames
        self.height, self.width = height, width
        self.fps, self.index_map, self.num_frames = plan_frame_selection(
            src_fps, src_num_frames, fps=self._want_fps,
            total=self._want_total)

    def _push(self, item) -> bool:
        """A bounded put that gives up once this subscriber is closed, so
        an abandoned family never wedges the bus. A put that found the
        queue full is put-blocked time (counter, trace span, depth)."""
        try:
            # the uncontended put takes no timing call
            self.queue.put_nowait(item)
            telemetry.gauge_set("vft_fanout_queue_depth",
                                self.queue.qsize(), family=self.family)
            return True
        except queue.Full:
            pass
        t0 = time.perf_counter()
        ok = False
        while not self.closed:
            try:
                self.queue.put(item, timeout=0.1)
                ok = True
                break
            except queue.Full:
                continue
        dt = time.perf_counter() - t0
        telemetry.inc("vft_fanout_put_blocked_ms_total", dt * 1e3,
                      family=self.family)
        tr = trace.active()
        if tr is not None and dt >= trace.STALL_MIN_S:
            tr.complete("fanout.put_blocked", t0, dt, family=self.family)
            tr.counter(f"fanout_queue_depth/{self.family}",
                       self.queue.qsize())
        if ok:
            telemetry.gauge_set("vft_fanout_queue_depth",
                                self.queue.qsize(), family=self.family)
        return ok

    # -- consumer side ------------------------------------------------------
    def __len__(self) -> int:
        return self.num_frames

    def _raise_if_cancelled(self) -> None:
        if self._cancelled:
            raise DeadlineExceeded(f"{self.path}: {self._cancel_reason}")

    def frames(self) -> Iterator[Tuple[np.ndarray, float, int]]:
        """``(frame, timestamp_ms, out_index)`` with the family's transform
        applied on the consuming thread, as ``VideoSource.frames``."""
        tf = self.transform
        try:
            while True:
                self._raise_if_cancelled()
                t_wait = time.perf_counter()
                while True:
                    try:
                        # a 1 s poll bounds how stale the cancel and
                        # liveness checks can be
                        tag, payload = self.queue.get(timeout=1.0)
                        break
                    except queue.Empty:
                        self._raise_if_cancelled()
                        t = self.bus._thread
                        if t is not None and t.is_alive():
                            continue
                        # the bus may have flushed its tail and exited
                        # between the timeout and the check: drain first
                        try:
                            tag, payload = self.queue.get_nowait()
                            break
                        except queue.Empty:
                            err = self._error
                            raise RuntimeError(
                                f"shared decode for {self.path} " +
                                (f"failed: {err}" if err
                                 else "died without a result")) from None
                # the time inside get() is this family idle on the decoder
                waited = time.perf_counter() - t_wait
                telemetry.inc("vft_fanout_get_starved_ms_total",
                              waited * 1e3, family=self.family)
                tr = trace.active()
                if tr is not None and waited >= trace.STALL_MIN_S:
                    tr.complete("fanout.get_starved", t_wait, waited,
                                family=self.family)
                if tag == "frame":
                    raw, out_idx = payload
                    with profiler.stage("decode"):
                        x = tf(raw) if tf is not None else raw
                    yield x, out_idx / self.fps * 1000.0, out_idx
                elif tag == "done":
                    return
                else:
                    raise RuntimeError(
                        f"shared decode failed for {self.path}: {payload}")
        finally:
            self.close()

    def __iter__(self):
        return _batched(self.frames(), self.batch_size, self.overlap)

    def cancel(self, reason: str = "cancelled") -> None:
        """Thread-safe kill (the deadline watchdog): closes this family's
        subscription only; the bus goes on serving the others."""
        self._cancel_reason = reason or "cancelled"
        self._cancelled = True
        self.close()

    def release(self) -> None:
        self.close()

    def close(self) -> None:
        """Mark abandoned and drain, so a bus blocked in a put sees it
        within its poll interval."""
        self.closed = True
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass


class FrameBus:
    """One shared decode pass over the union of N families' frame plans."""

    def __init__(self, path, expected_families: Sequence[str],
                 depth: int = DEFAULT_DEPTH):
        self.path = str(path)
        self.expected = frozenset(str(f) for f in expected_families)
        self.depth = int(depth)
        self._cond = threading.Condition()
        self._subs: Dict[str, SharedFrameSource] = {}
        self._done_families: set = set()
        self._finalizing = False
        self._plans_ready = False
        self._started = False
        self._probe_error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        #: source frames this bus decoded (read or grabbed): the one decode
        #: that the families share
        self.decoded = 0
        # seconds of the pass's reads, grabs and conversions so far
        self._decode_s = 0.0

    # -- family-side API ----------------------------------------------------
    def subscribe(self, family: str, *, batch_size: int = 1,
                  fps: Optional[float] = None, total: Optional[int] = None,
                  transform: Optional[Callable] = None, overlap: int = 0,
                  channel_order: str = "rgb",
                  **unsupported) -> Optional[SharedFrameSource]:
        """Join the shared pass: blocks until every expected family has
        arrived and the plans are probed, then returns the source. Returns
        ``None`` (decode privately) for a family that is not expected, has
        subscribed once already (a retry), arrives after decode started,
        or asks for a knob the shared pass cannot honour."""
        family = str(family)
        if any(v not in (None, "select", False) for v in
               unsupported.values()):
            return None
        with self._cond:
            if (family not in self.expected or family in self._subs
                    or family in self._done_families or self._started):
                return None
            sub = SharedFrameSource(
                self, family, batch_size=batch_size, fps=fps, total=total,
                transform=transform, overlap=overlap,
                channel_order=channel_order, depth=self.depth)
            self._subs[family] = sub
        # registered before the barrier wait, so the deadline watchdog can
        # cancel a family stuck waiting for its siblings
        ctx = faults.current_context()
        if ctx is not None:
            ctx.register(sub)
        self._maybe_finalize()
        t_wait = time.perf_counter()
        with self._cond:
            while not self._plans_ready and self._probe_error is None \
                    and not sub._cancelled:
                self._cond.wait(0.1)
            waited = time.perf_counter() - t_wait
            tr = trace.active()
            if tr is not None and waited >= trace.STALL_MIN_S:
                # the arrival barrier: this family waited on its siblings
                tr.complete("fanout.subscribe_wait", t_wait, waited,
                            family=family)
            sub._raise_if_cancelled()
            if self._probe_error is not None:
                # a fresh exception per waiter; the embedded type name
                # keeps utils/faults.classify's markers working
                raise RuntimeError(f"shared decode probe failed for "
                                   f"{self.path}: {self._probe_error}")
        return sub

    def done(self, family: str) -> None:
        """Mark ``family`` as never going to subscribe (again): skipped,
        served from the cache, quarantined, failed or finished; its
        subscription, if any, is closed, so a consumer that left without
        closing it never holds the bus. Idempotent; the barrier opens once
        every expected family subscribed or is done."""
        family = str(family)
        with self._cond:
            if family in self._done_families:
                return
            self._done_families.add(family)
            sub = self._subs.get(family)
        if sub is not None:
            sub.close()
        self._maybe_finalize()

    def shared_ms(self, family: str) -> Optional[float]:
        """The decode ms the bus had spent when ``family``'s stream
        completed; None for a family that did not subscribe."""
        sub = self._subs.get(str(family))
        return None if sub is None else sub.decode_shared_ms

    # -- barrier and plan probing -------------------------------------------
    def _all_arrived(self) -> bool:
        return self.expected <= (set(self._subs) | self._done_families)

    def _maybe_finalize(self) -> None:
        with self._cond:
            if self._finalizing or not self._all_arrived():
                return
            self._finalizing = True
            subs = list(self._subs.values())
        try:
            if subs:
                props = get_video_props(self.path)
                n = counted = props["num_frames"]
                if n <= 0 and any(s._want_fps is not None
                                  or s._want_total is not None
                                  for s in subs):
                    # metadata without a frame count: a resampling plan
                    # needs the real one, as a private source recounts
                    counted = count_frames_by_decode(self.path)
                    if counted == 0:
                        raise ValueError(
                            f"No decodable frames in {self.path}")
                for s in subs:
                    planned = (s._want_fps is not None
                               or s._want_total is not None)
                    s._set_plan(props["fps"], counted if planned else n,
                                props["height"], props["width"])
        except BaseException as e:
            with self._cond:
                self._probe_error = f"{type(e).__name__}: {e}"
                self._started = True  # no decode will run
                self._cond.notify_all()
            return
        with self._cond:
            self._plans_ready = True
            self._started = True
            self._cond.notify_all()
        if subs:
            self._thread = threading.Thread(
                target=self._decode, name="vft-fanout-decode", daemon=True)
            self._thread.start()

    # -- the single decode pass ---------------------------------------------
    def _finish_sub(self, sub: SharedFrameSource, emitted: int) -> None:
        sub.decode_shared_ms = round(self._decode_s * 1000.0, 3)
        sub._push(("done", emitted))

    def _decode(self) -> None:
        subs = list(self._subs.values())
        ptrs = {s.family: 0 for s in subs}
        emitted = {s.family: 0 for s in subs}
        finished: set = set()
        t_pass = time.perf_counter()
        stream = _FrameStream(self.path, channel_order=None)
        try:
            src_idx = 0
            while True:
                # which open subscribers need this source frame, and does
                # any still need a later one?
                wants: List[Tuple[SharedFrameSource, List[int]]] = []
                pending = False
                for s in subs:
                    if s.family in finished or s.closed:
                        continue
                    if s.index_map is None:
                        # native delivery: every frame until the end
                        wants.append((s, [src_idx]))
                        pending = True
                        continue
                    m = s.index_map
                    p = ptrs[s.family]
                    outs: List[int] = []
                    while p < len(m) and int(m[p]) == src_idx:
                        outs.append(p)  # repeated when upsampling
                        p += 1
                    ptrs[s.family] = p
                    if outs:
                        wants.append((s, outs))
                    if p < len(m):
                        pending = True
                if not wants and not pending:
                    break  # every plan is satisfied
                t0 = time.perf_counter()
                with profiler.stage("decode"):
                    if wants:
                        frame = stream.read()
                        ok = frame is not None
                    else:
                        ok = stream.skip()  # a frame no one keeps: grab
                        frame = None
                self._decode_s += time.perf_counter() - t0
                if not ok:
                    break  # the end of the stream
                self.decoded += 1
                if frame is not None:
                    by_order: Dict[str, np.ndarray] = {}
                    for s, outs in wants:
                        if s.closed:
                            continue
                        arr = by_order.get(s.channel_order)
                        if arr is None:
                            t1 = time.perf_counter()
                            with profiler.stage("decode"):
                                arr = by_order[s.channel_order] = \
                                    convert_decoded(frame, s.channel_order)
                            self._decode_s += time.perf_counter() - t1
                        for out_idx in outs:
                            if not s._push(("frame", (arr, out_idx))):
                                break  # the subscriber left mid-frame
                            emitted[s.family] += 1
                    for s in subs:
                        if s.family in finished or s.closed \
                                or s.index_map is None:
                            continue
                        if ptrs[s.family] >= len(s.index_map):
                            finished.add(s.family)
                            self._finish_sub(s, emitted[s.family])
                src_idx += 1
            for s in subs:
                if s.family in finished:
                    continue
                if s.index_map is not None \
                        and emitted[s.family] < len(s.index_map) \
                        and not s.closed:
                    print(f"Warning: {self.path} ended after {src_idx} "
                          f"frames (metadata said {s.src_num_frames}); "
                          f"{s.family} emitted {emitted[s.family]}/"
                          f"{len(s.index_map)} resampled frames.")
                self._finish_sub(s, emitted[s.family])
        except BaseException as e:
            # the name and message travel on, so the subscribers'
            # classify() sees what an inline failure would show (an
            # injected EIO stays TRANSIENT, ENOSPC stays FATAL)
            msg = f"{type(e).__name__}: {e}"
            telemetry.inc("vft_fanout_decode_errors_total")
            for s in subs:
                if s.family in finished:
                    continue
                s._error = msg
                s._push(("error", msg))
        finally:
            stream.release()
            # one span over the whole pass on the bus thread's lane: it
            # brackets the decode stages, and its gaps are the put stalls
            trace.complete("fanout.decode_pass", t_pass,
                           time.perf_counter() - t_pass, video=self.path,
                           families=len(subs))


class SharedDecodeSession:
    """One video's shared resources in one run: the visual families'
    :class:`FrameBus` and the audio families' one wav rip."""

    def __init__(self, video_path, visual_families: Sequence[str],
                 depth: int = DEFAULT_DEPTH):
        self.video_path = str(video_path)
        self.bus: Optional[FrameBus] = (
            FrameBus(video_path, visual_families, depth=depth)
            if visual_families else None)
        self._wav_lock = threading.Lock()
        self._wav: Optional[Tuple[str, str]] = None
        self._wav_error: Optional[str] = None

    def subscribe(self, family: str, **kwargs
                  ) -> Optional[SharedFrameSource]:
        if self.bus is None:
            return None
        return self.bus.subscribe(family, **kwargs)

    def family_done(self, family: str) -> None:
        if self.bus is not None:
            self.bus.done(family)

    def shared_ms(self, family: str) -> Optional[float]:
        return None if self.bus is None else self.bus.shared_ms(family)

    def shared_wav(self, video_path, tmp_path, ripper: Callable) -> str:
        """Rip the audio track once; every audio family reads the same wav.
        The session removes it (:meth:`cleanup`), since a family must not
        delete what a sibling may still read."""
        with self._wav_lock:
            if self._wav_error is not None:
                raise RuntimeError(f"shared wav rip failed for "
                                   f"{video_path}: {self._wav_error}")
            if self._wav is None:
                try:
                    with trace.span("wav_rip", video=str(video_path),
                                    shared=True):
                        self._wav = ripper(video_path, tmp_path)
                except BaseException as e:
                    self._wav_error = f"{type(e).__name__}: {e}"
                    raise
            return self._wav[0]

    def cleanup(self, keep_tmp: bool = False) -> None:
        """Remove the shared wav and aac (unless ``keep_tmp``), after every
        family's thread has joined."""
        with self._wav_lock:
            wav, self._wav = self._wav, None
        if wav and not keep_tmp:
            for p in wav:
                try:
                    os.remove(p)
                except OSError:
                    pass
