"""Per-video fault tolerance: taxonomy, retry policy, deadline watchdog,
decode ladder, failure journal.

The port's copy of ``video_features_tpu/utils/faults.py``:

  - :func:`classify` maps an exception to ``TRANSIENT`` (worth retrying),
    ``POISON`` (the input is bad: bounded retries, then quarantine) or
    ``FATAL`` (a config or programming error: fail the video at once);
    :class:`DeadlineExceeded` is TRANSIENT, :class:`PoisonError` and
    :class:`FatalError` mark their category explicitly, and a decode
    worker's forwarded error string is classified by its markers;
  - :data:`LADDER` / :func:`demote`: a retry of a video under
    ``video_decode=parallel`` or ``process`` runs with the next-simpler
    source (``parallel -> process -> inline``);
  - :class:`RetryPolicy`: ``retry_attempts`` total tries per video with
    exponential backoff and jitter (``retry_backoff_s``), the per-video
    ``video_deadline_s`` and ``retry_failed``;
  - :class:`FaultContext`: one attempt of one video, installed on its
    thread: a watchdog timer that cancels every registered decode source at
    the deadline (the source releases its capture or terminates its worker
    processes, and its ``frames()`` raises :class:`DeadlineExceeded`), and
    the ladder's ``decode_override`` that ``BaseExtractor.video_source``
    honours;
  - :class:`FailureJournal`: ``{output_path}/_failures.jsonl``, one
    atomically appended record per terminal failure
    (``telemetry/jsonl.py append_jsonl``); a rerun skips the videos whose
    latest record is POISON unless ``retry_failed=true``.

The watchdog counts ``vft_deadline_expirations_total`` and the journal
``vft_failures_total{category}`` (``telemetry/``; no-ops when off).
"""
from __future__ import annotations

import errno
import json
import os
import random
import socket
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

from .. import telemetry
from ..telemetry.context import current_request_id
from ..telemetry.jsonl import append_jsonl

TRANSIENT = "TRANSIENT"  # environment blip: retry with backoff
POISON = "POISON"        # the input is bad: bounded retries, then quarantine
FATAL = "FATAL"          # config/programming error: retrying cannot help


class DeadlineExceeded(Exception):
    """Raised by a cancelled video source when the per-video deadline kills
    its in-flight decode. TRANSIENT: a hung decode is usually a stalled
    read, and the retry also walks the decode ladder."""


class PoisonError(Exception):
    """Marks an input-is-bad failure explicitly (classify -> POISON)."""


class FatalError(Exception):
    """Marks a do-not-retry failure explicitly (classify -> FATAL)."""


#: substrings of a decode worker's forwarded error string (``f"{type(e)
#: .__name__}: {e}"``, utils/io.py) that mark the child's exception as
#: input-shaped
_POISON_MARKERS = ("ValueError", "PoisonError", "NonFiniteFeatureError",
                   "No decodable frames", "Cannot determine fps")

#: OSError errnos that mean the environment cannot take writes at all
#: (full disk, quota, read-only remount): every video would fail the same
#: way, so fail fast instead of burning the retry budget on each
_FATAL_ERRNOS = frozenset({
    getattr(errno, name) for name in ("ENOSPC", "EDQUOT", "EROFS")
    if hasattr(errno, name)
})

#: the same verdicts in a worker-forwarded error string
_FATAL_MARKERS = ("ENOSPC", "EDQUOT", "EROFS", "No space left on device",
                  "Disk quota exceeded", "Read-only file system")


def classify(exc: BaseException) -> str:
    """Map an exception to TRANSIENT / POISON / FATAL. Unknown exceptions
    are TRANSIENT: a wrong TRANSIENT costs a few bounded retries, a wrong
    POISON quarantines a healthy video."""
    if isinstance(exc, DeadlineExceeded):
        return TRANSIENT
    if isinstance(exc, FatalError):
        return FATAL
    if isinstance(exc, PoisonError):
        return POISON
    from ..telemetry.health import NonFiniteFeatureError
    if isinstance(exc, NonFiniteFeatureError):
        # health=true found NaN/Inf in a computed feature: quarantine over
        # a silent write (retries rarely fix such an input-model pair)
        return POISON
    if isinstance(exc, (NotImplementedError, AssertionError, TypeError,
                        AttributeError, NameError, ImportError)):
        return FATAL
    if isinstance(exc, (ValueError, KeyError, IndexError)):
        # cv2-can't-open / no-frames / bad-fps surface as ValueError
        return POISON
    if type(exc).__module__ == "cv2":
        return POISON  # codec/container rejection of this input
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if "died without a result" in msg:
            return TRANSIENT  # a decode worker killed from outside
        if any(m in msg for m in _POISON_MARKERS):
            return POISON  # a worker-forwarded child exception, by name
        if any(m in msg for m in _FATAL_MARKERS):
            return FATAL
        return TRANSIENT
    if isinstance(exc, OSError):
        return FATAL if exc.errno in _FATAL_ERRNOS else TRANSIENT
    return TRANSIENT


#: most- to least-parallel decode source; demotion walks rightward
LADDER = ("parallel", "process", "inline")


def demote(mode: Optional[str]) -> Optional[str]:
    """The next-simpler decode mode, or None at (or past) ``inline``."""
    if mode not in LADDER:
        return None
    i = LADDER.index(mode)
    return LADDER[i + 1] if i + 1 < len(LADDER) else None


@dataclass
class RetryPolicy:
    """``attempts`` counts total tries per video (1 = single shot).
    ``backoff_delay(k)`` is the sleep after failed attempt ``k``
    (1-based): ``backoff_s * 2**(k-1)``, capped, times ``1 + jitter * u``
    with ``u`` uniform in [0, 1). ``deadline_s`` is each attempt's
    wall-clock limit (None: none); ``ladder`` demotes ``video_decode`` on
    retries. Sleep and rng are injectable so tests never really sleep."""
    attempts: int = 1
    backoff_s: float = 0.5
    backoff_cap_s: float = 30.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None
    ladder: bool = True  # demote video_decode on retries
    retry_failed: bool = False  # re-run journal-quarantined inputs
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self):
        if int(self.attempts) < 1:
            raise ValueError(f"retry_attempts={self.attempts}: need >= 1")
        if float(self.backoff_s) < 0:
            raise ValueError(f"retry_backoff_s={self.backoff_s}: need >= 0")
        if self.deadline_s is not None and float(self.deadline_s) <= 0:
            raise ValueError(
                f"video_deadline_s={self.deadline_s}: need > 0 (or null)")
        self.attempts = int(self.attempts)

    @classmethod
    def from_config(cls, args) -> "RetryPolicy":
        """From the ``retry_attempts`` / ``retry_backoff_s`` /
        ``video_deadline_s`` / ``retry_failed`` keys (an unset key takes
        the JAX package's ``RetryPolicy`` default)."""
        attempts = args.get("retry_attempts")
        backoff = args.get("retry_backoff_s")
        deadline = args.get("video_deadline_s")
        return cls(attempts=1 if attempts is None else int(attempts),
                   backoff_s=0.5 if backoff is None else float(backoff),
                   deadline_s=None if deadline is None else float(deadline),
                   retry_failed=bool(args.get("retry_failed", False)))

    def backoff_delay(self, failed_attempt: int) -> float:
        base = min(float(self.backoff_s) * (2.0 ** (failed_attempt - 1)),
                   float(self.backoff_cap_s))
        return base * (1.0 + float(self.jitter) * self.rng.random())


_tls = threading.local()


def current_context() -> Optional["FaultContext"]:
    """The :class:`FaultContext` of the attempt running on this thread, if
    any (``BaseExtractor.video_source`` registers its sources there)."""
    return getattr(_tls, "ctx", None)


class FaultContext:
    """One extraction attempt of one video: the deadline watchdog and the
    ladder's decode override, installed thread-locally while it runs.

    The watchdog is a daemon ``threading.Timer``; at ``deadline_s`` it
    calls ``cancel()`` on every registered source, which releases the
    source's capture or terminates its worker processes (unblocking a stuck
    read) and makes its ``frames()`` raise :class:`DeadlineExceeded`: only
    this video fails, and the run goes on."""

    def __init__(self, video_path: str, deadline_s: Optional[float] = None,
                 decode_override: Optional[str] = None):
        self.video_path = str(video_path)
        self.deadline_s = deadline_s
        self.decode_override = decode_override
        self.deadline_expired = False
        self._sources: List = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._prev = None

    def register(self, source) -> None:
        """Track a live source; one registered after the deadline fired is
        cancelled at once."""
        with self._lock:
            expired = self.deadline_expired
            self._sources.append(source)
        if expired:
            self._cancel_source(source)

    def _cancel_source(self, source) -> None:
        try:
            source.cancel(f"video deadline ({self.deadline_s}s) exceeded "
                          f"for {self.video_path}")
        except Exception:
            traceback.print_exc()  # the watchdog must never die here

    def _expire(self) -> None:
        with self._lock:
            self.deadline_expired = True
            sources = list(self._sources)
        print(f"WATCHDOG: {self.video_path} exceeded video_deadline_s="
              f"{self.deadline_s}; killing its in-flight decode "
              f"({len(sources)} source(s))")
        telemetry.inc("vft_deadline_expirations_total")
        for s in sources:
            self._cancel_source(s)

    def __enter__(self) -> "FaultContext":
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self
        if self.deadline_s is not None:
            self._timer = threading.Timer(float(self.deadline_s),
                                          self._expire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        _tls.ctx = self._prev
        with self._lock:
            self._sources.clear()


class FailureJournal:
    """``{output_path}/_failures.jsonl``: one JSON record per terminal
    failure, ``{video, category, attempts, error, elapsed_s, host, time}``.
    :meth:`load` is last-record-wins per video, so a later ``RESOLVED``
    record (a ``retry_failed=true`` success) lifts a quarantine without
    rewriting history. Corrupt lines are skipped, never fatal."""

    FILENAME = "_failures.jsonl"
    RESOLVED = "RESOLVED"

    def __init__(self, output_path: Union[str, Path]):
        self.path = os.path.join(str(output_path), self.FILENAME)
        self._lock = threading.Lock()

    def record(self, video: str, category: str, attempts: int, error: str,
               elapsed_s: float) -> dict:
        rec = {"video": str(video), "category": str(category),
               "attempts": int(attempts), "error": str(error)[:1000],
               "elapsed_s": round(float(elapsed_s), 3),
               "host": socket.gethostname(), "time": time.time()}
        # the request in scope (telemetry/context.py), only when there is
        # one, so batch-run records keep their fields
        rid = current_request_id()
        if rid is not None:
            rec["request_id"] = rid
        with self._lock:
            append_jsonl(self.path, rec)
        telemetry.inc("vft_failures_total", category=str(category))
        return rec

    def resolve(self, video: str) -> None:
        """Lift a quarantine after a ``retry_failed=true`` success."""
        with self._lock:
            append_jsonl(self.path, {"video": str(video),
                                     "category": self.RESOLVED,
                                     "host": socket.gethostname(),
                                     "time": time.time()})

    def load(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                for raw in f:
                    try:
                        rec = json.loads(raw)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "video" in rec:
                        out[str(rec["video"])] = rec
        except OSError:
            return {}
        return out

    def poison_record(self, video: str) -> Optional[dict]:
        """This video's latest record iff it quarantines (category
        POISON); TRANSIENT and FATAL terminal failures are tried again by a
        rerun."""
        rec = self.load().get(str(video))
        if rec is not None and rec.get("category") == POISON:
            return rec
        return None
