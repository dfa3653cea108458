"""Per-video lifecycle spans: one JSONL record per video attempt-set (port
of ``video_features_tpu/telemetry/spans.py``).

A :class:`VideoSpan` covers everything that happens to one video under
``safe_extract`` (``utils/sinks.py``): every retry, decode-ladder demotion,
stage timing and the terminal status, flattened into ONE record appended to
``{output_path}/_telemetry.jsonl``: which video stalled, how many attempts
it burned, whether decode or forward dominated, and why it failed.

Propagation is thread-local (:func:`current_span` / :func:`use_span`):
``safe_extract`` runs under the span installed on its thread, and the
decode-ahead thread (``utils/io.py Prefetcher``) re-installs the span it
captured at construction, so the producer thread's ``decode`` timings still
attribute to the right video. Stage observations on threads without a span
(a spawned decode child, the shared decode's bus thread) are not attributed
per video but still land in the run's histograms (``telemetry/metrics.py``).

The record shape is frozen by ``video_span.schema.json`` (same directory,
a copy of the JAX package's); :data:`SPAN_FIELDS` is the emitter's side of
that contract.
"""
from __future__ import annotations

import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

#: schema identifier stamped into every record; bump on breaking change
SCHEMA_VERSION = "vft.video_span/1"

#: terminal statuses, mirroring safe_extract's return values
STATUSES = ("done", "skipped", "error", "quarantined")

#: cap on per-span timeline events: the first N are kept verbatim, the
#: overflow is counted and reported as one final ``events_dropped``
#: record. A pathological retry loop (or a future instrumentation bug)
#: must never grow a span's in-memory record without bound before it
#: serializes — spans are per-video observations, not logs.
MAX_SPAN_EVENTS = 256

#: exactly the top-level keys of every emitted record, in emit order; the
#: JSON Schema's properties, and the JAX package's tuple, are these
SPAN_FIELDS = (
    "schema", "video", "status", "feature_type", "host", "host_id", "pid",
    "request_id", "start_time", "wall_s", "attempts", "category", "error",
    "decode_mode", "decode_shared_ms", "ladder_steps", "stages",
    "video_fps", "video_frames", "events",
)

_tls = threading.local()


def current_span() -> Optional["VideoSpan"]:
    """The span installed on THIS thread, if any (cheap: one getattr)."""
    return getattr(_tls, "span", None)


@contextmanager
def use_span(span: Optional["VideoSpan"]) -> Iterator[None]:
    """Install ``span`` thread-locally for a block — how decode-ahead
    producer threads inherit the consumer's per-video attribution."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    try:
        yield
    finally:
        _tls.span = prev


class VideoSpan:
    """Accumulates one video's lifecycle; emits on ``__exit__``.

    Safe for concurrent stage observations (decode producer thread +
    consumer thread); annotations/events are expected from the owning
    thread but are lock-guarded anyway — a span must never corrupt
    under misuse, only lose precision.
    """

    def __init__(self, video: str, recorder=None,
                 feature_type: Optional[str] = None,
                 host_id: Optional[str] = None) -> None:
        from .context import current_request_id
        self.video = str(video)
        self.recorder = recorder
        self.feature_type = feature_type
        self.host_id = host_id
        # request-scoped correlation (telemetry/context.py): spans are
        # minted on the serve worker thread that owns the request, so the
        # id is captured here once; None outside serve mode
        self.request_id = current_request_id()
        self.record: Optional[dict] = None  # set at __exit__
        self._lock = threading.Lock()
        self._attrs: Dict[str, Any] = {}
        self._stages: Dict[str, List[float]] = {}  # name -> [seconds, calls]
        self._events: List[dict] = []
        self._events_dropped = 0
        self._ladder: List[str] = []
        self._t0 = time.perf_counter()
        self._start_time = time.time()
        self._prev = None

    # -- instrumentation points (called from sinks/faults/io/base) ----------
    def observe_stage(self, name: str, dt: float) -> None:
        with self._lock:
            s = self._stages.get(name)
            if s is None:
                self._stages[name] = [dt, 1]
            else:
                s[0] += dt
                s[1] += 1

    def annotate(self, **kw: Any) -> None:
        """Set/overwrite top-level record attributes (status, attempts,
        category, error, decode_mode, video_fps, video_frames...).
        Unknown keys are dropped at build time, never emitted — the
        schema is closed."""
        with self._lock:
            self._attrs.update(kw)

    def event(self, kind: str, **kw: Any) -> None:
        """Append a timeline event (retry, ladder, quarantine, source...)
        stamped with seconds-since-span-start. Capped at
        :data:`MAX_SPAN_EVENTS` (first N kept, overflow counted) so a
        runaway retry loop cannot grow the record without bound."""
        rec = {"kind": str(kind),
               "t": round(time.perf_counter() - self._t0, 4)}
        rec.update(kw)
        with self._lock:
            if len(self._events) < MAX_SPAN_EVENTS:
                self._events.append(rec)
            else:
                self._events_dropped += 1
            # ladder_steps stays complete past the cap: it is its own
            # bounded field (one entry per demotion, ladder depth <= 2)
            if kind == "ladder":
                to = kw.get("to")
                if to is not None:
                    self._ladder.append(str(to))

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "VideoSpan":
        self._prev = getattr(_tls, "span", None)
        _tls.span = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _tls.span = self._prev
        wall = time.perf_counter() - self._t0
        with self._lock:
            attrs = dict(self._attrs)
            stages = {k: {"s": round(v[0], 6), "calls": int(v[1])}
                      for k, v in self._stages.items()}
            events = list(self._events)
            dropped = self._events_dropped
            ladder = list(self._ladder)
        if dropped:
            events.append({"kind": "events_dropped", "count": int(dropped),
                           "t": round(wall, 4)})
        status = attrs.get("status")
        if status not in STATUSES:
            # an exception propagated past safe_extract (KeyboardInterrupt,
            # SystemExit) or the caller forgot to annotate: still emit a
            # well-formed record
            status = "error"
        err = attrs.get("error")
        self.record = {
            "schema": SCHEMA_VERSION,
            "video": self.video,
            "status": status,
            "feature_type": self.feature_type,
            "host": socket.gethostname(),
            "host_id": self.host_id,
            "pid": os.getpid(),
            "request_id": self.request_id,
            "start_time": round(self._start_time, 3),
            "wall_s": round(wall, 6),
            "attempts": int(attrs.get("attempts", 1)),
            "category": attrs.get("category"),
            "error": None if err is None else str(err)[:1000],
            "decode_mode": attrs.get("decode_mode"),
            # multi-family shared-decode attribution: ms of the video's
            # single decode pass that had run when this family's stream
            # completed (parallel/fanout.py); null for private decodes
            "decode_shared_ms": _maybe_float(attrs.get("decode_shared_ms")),
            "ladder_steps": ladder,
            "stages": stages,
            "video_fps": _maybe_float(attrs.get("video_fps")),
            "video_frames": _maybe_int(attrs.get("video_frames")),
            "events": events,
        }
        if self.recorder is not None:
            try:
                self.recorder.emit_span(self.record)
            except Exception as e:
                # a full disk / permission flap on the telemetry channel
                # must never fail the video it observed
                print(f"telemetry: failed to record span for {self.video}: "
                      f"{type(e).__name__}: {e}")


def _maybe_float(v: Any) -> Optional[float]:
    try:
        return None if v is None else float(v)
    except (TypeError, ValueError):
        return None


def _maybe_int(v: Any) -> Optional[int]:
    try:
        return None if v is None else int(v)
    except (TypeError, ValueError):
        return None


class NoopSpan:
    """The ``telemetry=false`` hot path: every method is a constant-time
    no-op and ``with`` never touches thread-local state. A single shared
    instance is safe — there is nothing to share."""

    __slots__ = ()

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def observe_stage(self, name: str, dt: float) -> None:
        pass

    def annotate(self, **kw: Any) -> None:
        pass

    def event(self, kind: str, **kw: Any) -> None:
        pass


NOOP_SPAN = NoopSpan()
