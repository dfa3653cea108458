"""Cross-video clip batching (port of
``video_features_tpu/parallel/packer.py``): fill device groups from several
videos' clips at once.

Per-video streams (``parallel/mesh.py`` ``FeatureStream``) send each video's
last group short. The packer instead keeps ONE buffer shared by the
``video_workers`` threads: a group dispatches only when FULL; the exception
is a flush when every still-open video is already waiting to close (nobody
is left to fill it), which in a run whose every video is open is the final
one.

Ordering contract: results come back per video, in that video's clip
order, equal to the unpacked path's rows: group membership only changes a
clip's neighbours in the batch, and the forward is row-wise (on the card a
different batch size may pick another cuDNN algorithm, so rows agree to
float32 rounding there; tests/test_torch_packer.py).

Concurrency design (all state under one lock; D2H copies outside it):

  - ``add`` appends to the shared buffer; a full buffer dispatches the
    forward at once (``runner.dispatch`` launches and returns);
  - ``close_video`` blocks until all of that video's clips have
    materialized. Whoever observes work in flight drains the oldest group
    (a second lock keeps drains in submit order); when every open video is
    closing and clips still sit in the unfilled buffer, the buffer is
    flushed short, so all ``video_workers`` closing at once cannot
    deadlock;
  - ``depth`` bounds the un-materialized groups, as FeatureStream's does;
  - a group that fails (dispatch raises, or the blocking read raises)
    poisons exactly its member videos: their pending counts are released
    and ``close_video`` raises for each, so the failure stays per video
    and the rest of the corpus completes. Nothing is retried on another
    device.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.profiling import profiler
from .mesh import to_host


class ClipPacker:
    """One shared buffer of ``batch`` clips over ``runner.dispatch``; see
    the module docstring for the contract."""

    def __init__(self, runner, batch: int, depth: int = 4):
        self.runner = runner
        self.batch = int(batch)
        self.depth = max(int(depth), 1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._drain_lock = threading.Lock()     # serializes D2H
        self._dispatch_lock = threading.Lock()  # serializes group dispatch
        self._buf: List[tuple] = []          # [(handle, idx, stack), ...]
        self._inflight: deque = deque()      # [(device_array, manifest)]
        self._results: Dict[int, Dict[int, np.ndarray]] = {}
        self._counts: Dict[int, int] = {}    # clips added per handle
        self._pending: Dict[int, int] = {}   # clips not yet materialized
        self._errors: Dict[int, Exception] = {}  # poisoned-group handles
        self._open = 0
        self._closing = 0
        self._next_handle = 0

    # -- per-video API (each video's decode thread) ------------------------

    def open_video(self) -> int:
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._results[h] = {}
            self._counts[h] = 0
            self._pending[h] = 0
            self._open += 1
            return h

    def add(self, handle: int, stack: np.ndarray) -> None:
        """Append one clip stack; dispatches when the shared group fills."""
        to_dispatch = None
        with self._lock:
            err = self._errors.get(handle)
            if err is not None:
                # an earlier group containing our clips already failed:
                # stop this video now (the caller's except-path aborts it)
                # instead of decoding + dispatching clips whose only
                # possible outcome is a close_video failure
                raise RuntimeError(
                    "a packed clip group containing this video's clips "
                    f"failed on device: {err}") from err
            self._buf.append((handle, self._counts[handle], stack))
            self._counts[handle] += 1
            self._pending[handle] += 1
            if len(self._buf) >= self.batch:
                to_dispatch, self._buf = self._buf, []
        if to_dispatch is not None:
            # a dispatch failure contains OUR newest clip: propagate so the
            # caller's extractor aborts this video now (members poisoned)
            self._dispatch(to_dispatch)
            with self._lock:
                drain = len(self._inflight) > self.depth
            if drain:
                try:
                    self._drain_oldest()
                except Exception:
                    pass  # the failed group's members are poisoned; each
                    # surfaces at its own close_video, not at this add

    def abort_video(self, handle: int) -> None:
        """Error-path cleanup (per-video isolation): discard the video's
        buffered clips and stop counting it as open. Without this, a video
        that dies after open_video() would leave ``_open`` elevated forever
        and the all-closing flush rule could never fire — wedging every
        other worker's close_video. Rows of its already-dispatched clips
        are dropped at drain time (the results entry is gone)."""
        with self._lock:
            self._buf = [e for e in self._buf if e[0] != handle]
            self._results.pop(handle, None)
            self._counts.pop(handle, None)
            self._pending.pop(handle, None)
            self._errors.pop(handle, None)
            self._open -= 1
            self._cond.notify_all()

    def close_video(self, handle: int) -> np.ndarray:
        """Block until every clip of ``handle`` materialized; return the
        (n_clips, ...) feature rows in add order."""
        with self._lock:
            self._closing += 1
        try:
            while True:
                to_flush = None
                with self._lock:
                    # pending counts buffered AND in-flight clips, so zero
                    # means everything of ours has materialized. A poisoned
                    # handle breaks out regardless of the count — the error
                    # (raised below) is the result, and waiting on counts a
                    # failed drain may not have balanced would hang instead
                    # of surfacing it.
                    if self._pending[handle] == 0 or handle in self._errors:
                        break
                    if not self._inflight:
                        if self._buf and self._closing >= self._open:
                            # every open video is closing: nobody will fill
                            # the group, so it goes out short
                            to_flush, self._buf = self._buf, []
                        else:
                            # other videos are still decoding; their adds
                            # will fill the buffer. The timeout guards the
                            # race where the last feeder transitions to
                            # closing between our check and the wait.
                            self._cond.wait(timeout=0.05)
                            continue
                if to_flush is not None:
                    try:
                        self._dispatch(to_flush)
                    except Exception:
                        continue  # members poisoned; ours surfaces below
                try:
                    self._drain_oldest()
                except Exception:
                    pass  # poisoned members (possibly us) surface below
        finally:
            with self._lock:
                self._closing -= 1
                self._open -= 1
                rows = self._results.pop(handle)
                n = self._counts.pop(handle)
                self._pending.pop(handle)
                err = self._errors.pop(handle, None)
        if err is not None:
            raise RuntimeError(
                "a packed clip group containing this video's clips failed "
                f"on device: {err}") from err
        if n == 0:
            return np.empty((0,), np.float32)
        return np.stack([rows[i] for i in range(n)])

    # -- internals ---------------------------------------------------------

    def _dispatch(self, items: List[tuple]) -> None:
        """Stack + launch a group WITHOUT the main lock held (the host copy
        of a large group is tens of MB; holding the lock there would stall
        every decode thread). The dispatch lock keeps the inflight order
        consistent with dispatch order."""
        with self._dispatch_lock:
            manifest = [(h, idx) for h, idx, _ in items]
            try:
                # np.stack inside the try: a shape mismatch or MemoryError
                # here has already consumed the clips from _buf, so it must
                # poison the members exactly like a device failure
                group = np.stack([s for _, _, s in items])
                dev = self.runner.dispatch(group)
            except Exception as e:
                self._poison(manifest, e)
                raise
            with self._lock:
                self._inflight.append((dev, manifest))
                self._cond.notify_all()

    def _poison(self, manifest, exc: Exception) -> None:
        """A group died on device: release its members' pending counts and
        record the error so each member's ``close_video`` raises instead of
        spinning forever on clips that will never materialize."""
        with self._lock:
            for h, _idx in manifest:
                if h in self._pending:
                    self._pending[h] -= 1
                    self._errors[h] = exc
            self._cond.notify_all()

    def _drain_oldest(self) -> None:
        """Materialize the oldest in-flight group (if any) and route its
        rows to their videos. D2H happens outside the main lock so decode
        threads keep feeding; the drain lock keeps materialization
        submit-ordered."""
        with self._drain_lock:
            with self._lock:
                if not self._inflight:
                    return
                dev, manifest = self._inflight.popleft()
            # ANY failure after the pop (the blocking D2H is the expected
            # one, but also e.g. a routing bug below) must poison the
            # members — once the group left _inflight, nobody else can
            # materialize it, and un-poisoned members would spin in
            # close_video forever instead of surfacing the error
            try:
                # the stage contract of FeatureStream._pop: the host's
                # stall until the group's result lands
                with profiler.stage("forward"):
                    host = to_host(dev)  # blocking D2H
                with self._lock:
                    for row, (h, idx) in enumerate(manifest):
                        if h in self._results:
                            self._results[h][idx] = host[row]
                            self._pending[h] -= 1
                    self._cond.notify_all()
            except Exception as e:
                self._poison(manifest, e)
                raise
