"""Per-video fault tolerance: taxonomy, retry policy, failure journal.

The port's copy of the parts of ``video_features_tpu/utils/faults.py`` the
inline decode path runs:

  - :func:`classify` maps an exception to ``TRANSIENT`` (worth retrying),
    ``POISON`` (the input is bad: bounded retries, then quarantine) or
    ``FATAL`` (a config or programming error: fail the video at once);
  - :class:`RetryPolicy`: ``retry_attempts`` total tries per video with
    exponential backoff and jitter (``retry_backoff_s``), and
    ``retry_failed``;
  - :class:`FailureJournal`: ``{output_path}/_failures.jsonl``, one
    atomically appended record per terminal failure; a rerun skips the
    videos whose latest record is POISON unless ``retry_failed=true``.

The per-video deadline watchdog (``video_deadline_s``) and the decode
degradation ladder are not here: they need the decode sources' cancel hooks
and the process/parallel decode modes, which the port does not have yet
(``config.check_ported`` rejects ``video_deadline_s``).
"""
from __future__ import annotations

import errno
import json
import os
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Union

TRANSIENT = "TRANSIENT"  # environment blip: retry with backoff
POISON = "POISON"        # the input is bad: bounded retries, then quarantine
FATAL = "FATAL"          # config/programming error: retrying cannot help

#: OSError errnos that mean the environment cannot take writes at all
#: (full disk, quota, read-only remount): every video would fail the same
#: way, so fail fast instead of burning the retry budget on each
_FATAL_ERRNOS = frozenset({
    getattr(errno, name) for name in ("ENOSPC", "EDQUOT", "EROFS")
    if hasattr(errno, name)
})


def classify(exc: BaseException) -> str:
    """Map an exception to TRANSIENT / POISON / FATAL. Unknown exceptions
    are TRANSIENT: a wrong TRANSIENT costs a few bounded retries, a wrong
    POISON quarantines a healthy video."""
    if isinstance(exc, (NotImplementedError, AssertionError, TypeError,
                        AttributeError, NameError, ImportError)):
        return FATAL
    if isinstance(exc, (ValueError, KeyError, IndexError)):
        # cv2-can't-open / no-frames / bad-fps surface as ValueError
        return POISON
    if type(exc).__module__ == "cv2":
        return POISON  # codec/container rejection of this input
    if isinstance(exc, OSError):
        return FATAL if exc.errno in _FATAL_ERRNOS else TRANSIENT
    return TRANSIENT


@dataclass
class RetryPolicy:
    """``attempts`` counts total tries per video (1 = single shot).
    ``backoff_delay(k)`` is the sleep after failed attempt ``k``
    (1-based): ``backoff_s * 2**(k-1)``, capped, times ``1 + jitter * u``
    with ``u`` uniform in [0, 1). Sleep and rng are injectable so tests
    never really sleep."""
    attempts: int = 1
    backoff_s: float = 0.5
    backoff_cap_s: float = 30.0
    jitter: float = 0.1
    retry_failed: bool = False  # re-run journal-quarantined inputs
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self):
        if int(self.attempts) < 1:
            raise ValueError(f"retry_attempts={self.attempts}: need >= 1")
        if float(self.backoff_s) < 0:
            raise ValueError(f"retry_backoff_s={self.backoff_s}: need >= 0")
        self.attempts = int(self.attempts)

    @classmethod
    def from_config(cls, args) -> "RetryPolicy":
        """From the ``retry_attempts`` / ``retry_backoff_s`` /
        ``retry_failed`` keys (an unset key takes the JAX package's
        ``RetryPolicy`` default)."""
        attempts = args.get("retry_attempts")
        backoff = args.get("retry_backoff_s")
        return cls(attempts=1 if attempts is None else int(attempts),
                   backoff_s=0.5 if backoff is None else float(backoff),
                   retry_failed=bool(args.get("retry_failed", False)))

    def backoff_delay(self, failed_attempt: int) -> float:
        base = min(float(self.backoff_s) * (2.0 ** (failed_attempt - 1)),
                   float(self.backoff_cap_s))
        return base * (1.0 + float(self.jitter) * self.rng.random())


def append_jsonl(path: str, rec: dict) -> None:
    """Append one record as a single ``os.write`` on an ``O_APPEND`` fd
    (concurrent writers never interleave partial lines), first healing a
    torn tail left by a killed writer with a newline."""
    line = (json.dumps(rec, sort_keys=True) + "\n").encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        if os.fstat(fd).st_size > 0:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    line = b"\n" + line
        os.write(fd, line)
    finally:
        os.close(fd)


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
        with self._lock:
            append_jsonl(self.path, rec)
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
