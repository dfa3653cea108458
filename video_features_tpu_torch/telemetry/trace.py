"""Pipeline tracing: a Chrome-trace-event timeline of the host pipeline
(port of ``video_features_tpu/telemetry/trace.py``).

Every ``profiler.stage`` call, every fan-out backpressure stall, prefetch
wait and retry backoff becomes one event in ``{output_path}/_trace.json``,
in the Chrome trace-event format that Perfetto and ``chrome://tracing``
read, the format ``torch.profiler``'s device trace is written in too
(``utils/profiling.py TraceCapture``).

In order: one global read when off (:func:`span` hands out a shared no-op,
per-frame call sites skip even the kwargs when :func:`active` is None);
per-THREAD buffers when on (each buffer has one writer, the recorder lock
is taken once per thread and once at drain); a cap of
:data:`MAX_EVENTS_PER_THREAD` events a thread, the overflow counted in
``otherData``; and the file written once, at :meth:`TraceRecorder.close`,
by temp file + fsync + ``os.replace`` (``telemetry/jsonl.py``): complete or
absent, never torn.

``trace=true`` turns it on (``cli.py`` owns the recorder), with or without
``telemetry=true``. The event vocabulary and the required fields of each
phase are the JAX package's (:data:`REQUIRED_X_FIELDS`,
:data:`KNOWN_SPAN_NAMES`), so the JAX package's trace tools read the port's
traces as they read their own, and ``python -m
video_features_tpu_torch.fleet_report --stitch`` merges the hosts' traces of
a shared root into one timeline; the ``fleet.*`` names are the fleet
queue's (``parallel/queue.py``). ``fleet=queue`` workers and servers on one
spool each write ``_trace_{host_id}.json`` (:func:`trace_filename`).
"""
from __future__ import annotations

import os
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.profiling import profiler
from . import jsonl

TRACE_FILENAME = "_trace.json"

#: stitched outputs share the ``_trace`` prefix but are never inputs: the
#: fleet stitcher (``fleet_report.py find_trace_files``) skips them
TRACE_OUTPUT_NAMES = ("_trace_fleet.json", "_trace_merged.json")

#: trace format identifier stamped into ``otherData``
TRACE_SCHEMA = "vft.trace/1"

#: required keys per event phase (the JAX package's)
REQUIRED_X_FIELDS = ("ph", "ts", "dur", "pid", "tid", "name")
REQUIRED_I_FIELDS = ("ph", "ts", "pid", "tid", "name")
REQUIRED_C_FIELDS = ("ph", "ts", "pid", "name", "args")
REQUIRED_M_FIELDS = ("ph", "pid", "name", "args")

#: the span vocabulary the instrumentation emits (beyond the
#: profiler.stage names, which arrive verbatim: decode/h2d/forward/write);
#: trace_report.py's stall ranking and critical-path verdict key
#: off these names
KNOWN_SPAN_NAMES = (
    "video_attempt",        # one safe_extract attempt (args: video, attempt)
    "family",               # one family's whole per-video job (multi runs)
    "fanout.decode_pass",   # the FrameBus union decode pass, whole video
    "fanout.put_blocked",   # decoder blocked: a family's queue was full
    "fanout.get_starved",   # family blocked: waiting on the decoder
    "fanout.subscribe_wait",  # family blocked at the arrival barrier
    "prefetch.next",        # decode-ahead producer pulling one batch
    "prefetch.put_blocked",  # producer blocked: consumer fell behind
    "retry_backoff",        # fault-runtime sleep between attempts
    "wav_rip",              # ffmpeg audio rip (shared or private)
    "source_probe",         # private VideoSource construction/probing
    "fleet.claim",          # work-queue claim attempt (parallel/queue.py)
    "fleet.steal",          # instant: claimed a reclaimed item
    "fleet.reclaim",        # instant: expired lease pushed back to pending
    "fleet.idle_wait",      # queue empty, other hosts hold live leases
    "fleet.canary",         # joining-host canary re-extraction
)

#: stall names ranked by trace_report.py "top stalls" —
#: fleet.idle_wait is the per-host idle TAIL (this worker out of work
#: while a straggler finishes), the makespan cost work-stealing shrinks
STALL_SPAN_NAMES = ("fanout.put_blocked", "fanout.get_starved",
                    "fanout.subscribe_wait", "prefetch.put_blocked",
                    "retry_backoff", "fleet.idle_wait")

#: stalls shorter than this never become trace events (they still
#: accumulate into the telemetry counters): a healthy pipeline performs
#: thousands of sub-millisecond queue waits per video, and recording
#: each would cost more than the stall it observes
STALL_MIN_S = 0.001

#: per-thread event cap: first N kept, overflow counted in ``otherData``
MAX_EVENTS_PER_THREAD = 500_000

def trace_filename(host_id: Optional[str] = None) -> str:
    """``_trace.json`` for a single-writer output dir,
    ``_trace_{host_id}.json`` when several hosts co-own one dir
    (``fleet=queue`` workers, servers sharing a spool), so no host's close
    overwrites another's timeline (the JAX package's names)."""
    if host_id is None:
        return TRACE_FILENAME
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(host_id))
    return f"_trace_{safe}.json"


#: the active run's TraceRecorder, or None (tracing disabled)
_active: Optional["TraceRecorder"] = None


def _set_active(recorder: Optional["TraceRecorder"]) -> None:
    global _active
    _active = recorder


def active() -> Optional["TraceRecorder"]:
    """The active :class:`TraceRecorder`, if any (one global read).

    Hot per-frame call sites hold the result in a local and skip even
    the kwargs construction when it is None."""
    return _active


class _NoopTraceSpan:
    """``trace=false`` hot path: a single shared, state-free ``with``."""

    __slots__ = ()

    def __enter__(self) -> "_NoopTraceSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_TRACE_SPAN = _NoopTraceSpan()


# -- module-level helpers (no-ops when tracing is off) -----------------------

def span(name: str, **args: Any):
    """Context manager timing a block into one complete ('X') event."""
    r = _active
    if r is None:
        return NOOP_TRACE_SPAN
    return _TraceSpan(r, name, args)


def complete(name: str, t0: float, dur_s: float, **args: Any) -> None:
    """Record an externally-timed block (``t0`` from
    ``time.perf_counter()``) as one complete event."""
    r = _active
    if r is not None:
        r.complete(name, t0, dur_s, **args)


def instant(name: str, **args: Any) -> None:
    """Record a point-in-time marker."""
    r = _active
    if r is not None:
        r.instant(name, **args)


class _TraceSpan:
    """The armed ``with`` returned by :func:`span`: times the block and
    emits on exit (exceptional exits included — a failed attempt is
    exactly the kind of span an operator wants on the timeline)."""

    __slots__ = ("_r", "_name", "_args", "_t0")

    def __init__(self, recorder: "TraceRecorder", name: str,
                 args: Dict[str, Any]) -> None:
        self._r = recorder
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_TraceSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._r.complete(self._name, self._t0,
                         time.perf_counter() - self._t0, **self._args)
        return None


class _ThreadBuf:
    __slots__ = ("events", "dropped", "tid", "tname")

    def __init__(self, tid: int, tname: str) -> None:
        self.events: List[dict] = []
        self.dropped = 0
        self.tid = tid
        self.tname = tname


class TraceRecorder:
    """Run-scoped trace collection: construct, :meth:`start`, let the
    instrumentation points feed it, :meth:`close` in a ``finally``.

    Also installs itself as the :class:`StageProfiler` trace hook, so
    every existing ``profiler.stage("decode"|"forward"|"write")`` call
    site becomes a timeline span with zero new code in the hot loops —
    the same piggyback the telemetry recorder uses for histograms.
    """

    def __init__(self, output_path: str, *,
                 host_id: Optional[str] = None,
                 max_events_per_thread: int = MAX_EVENTS_PER_THREAD) -> None:
        self.output_path = str(output_path)
        self.host_id = host_id
        self.trace_path = os.path.join(self.output_path,
                                       trace_filename(host_id))
        self.pid = os.getpid()
        self.max_events_per_thread = int(max_events_per_thread)
        self._t0 = time.perf_counter()
        self._start_unix = time.time()
        self._lock = threading.Lock()
        self._bufs: List[_ThreadBuf] = []
        self._tls = threading.local()
        self._closed = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "TraceRecorder":
        os.makedirs(self.output_path, exist_ok=True)
        _set_active(self)
        profiler.set_trace_hook(self._observe_stage)
        return self

    def close(self) -> Optional[str]:
        """Uninstall the hooks and drain every thread buffer into
        ``_trace.json`` (atomic temp+rename — complete or absent, never
        torn). Idempotent; never raises into the caller's finally.
        Returns the written path, or None."""
        if self._closed:
            return None
        self._closed = True
        profiler.set_trace_hook(None)
        if _active is self:
            _set_active(None)
        try:
            jsonl.write_json_atomic(self.trace_path, self.build_trace(),
                                    indent=None)
            return self.trace_path
        except Exception as e:
            # ENOSPC discipline: a failed trace drain is the loss of one
            # diagnostic artifact, never a crashed run — named once, and
            # counted on the active recorder when there is one
            from . import inc
            inc("vft_telemetry_write_failures_total", pillar="trace")
            print(f"trace: failed to write {self.trace_path}: "
                  f"{type(e).__name__}: {e}")
            return None

    # -- event emission (any thread) ----------------------------------------
    def _buf(self) -> _ThreadBuf:
        b = getattr(self._tls, "buf", None)
        if b is None:
            b = _ThreadBuf(threading.get_ident(),
                           threading.current_thread().name)
            with self._lock:
                self._bufs.append(b)
            self._tls.buf = b
        return b

    def _ts_us(self, perf_t: float) -> float:
        return round((perf_t - self._t0) * 1e6, 3)

    def _emit(self, ev: dict) -> None:
        if self._closed:
            return  # a straggler thread after drain: drop, never corrupt
        b = self._buf()
        if len(b.events) >= self.max_events_per_thread:
            b.dropped += 1
            return
        b.events.append(ev)

    def span(self, name: str, **args: Any) -> _TraceSpan:
        return _TraceSpan(self, name, args)

    def complete(self, name: str, t0: float, dur_s: float,
                 **args: Any) -> None:
        ev = {"ph": "X", "name": str(name), "ts": self._ts_us(t0),
              "dur": round(dur_s * 1e6, 3), "pid": self.pid,
              "tid": threading.get_ident(), "cat": "host"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, **args: Any) -> None:
        ev = {"ph": "i", "name": str(name),
              "ts": self._ts_us(time.perf_counter()), "pid": self.pid,
              "tid": threading.get_ident(), "cat": "host", "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, value: float,
                series: str = "value") -> None:
        self._emit({"ph": "C", "name": str(name),
                    "ts": self._ts_us(time.perf_counter()), "pid": self.pid,
                    "tid": threading.get_ident(), "cat": "host",
                    "args": {series: value}})

    # -- the StageProfiler trace hook ---------------------------------------
    def _observe_stage(self, name: str, t0: float, dt: float) -> None:
        # stage names (decode/forward/write) arrive verbatim; thread
        # identity is the attribution axis — the bus decode thread, each
        # family thread and each prefetch thread get their own lane
        self.complete(name, t0, dt)

    # -- drain --------------------------------------------------------------
    def build_trace(self) -> dict:
        with self._lock:
            bufs = list(self._bufs)
        events: List[dict] = []
        dropped = 0
        for b in bufs:
            events.extend(b.events)
            dropped += b.dropped
        events.sort(key=lambda e: e.get("ts", -1.0))
        meta: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": self.pid,
            "args": {"name": f"vft-host {socket.gethostname()}"}}]
        for b in bufs:
            meta.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                         "tid": b.tid, "args": {"name": b.tname}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": TRACE_SCHEMA,
                "host": socket.gethostname(),
                "host_id": self.host_id,
                "pid": self.pid,
                # the wall-clock anchor: event time = start_unix + ts/1e6.
                # trace_report --merge and vft-fleet --stitch align
                # timelines from different hosts/runs on it
                "start_unix": round(self._start_unix, 3),
                "wall_s": round(time.perf_counter() - self._t0, 3),
                "events": len(events),
                "dropped_events": dropped,
            },
        }
