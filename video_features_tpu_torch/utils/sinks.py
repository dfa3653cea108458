"""Output sinks and the idempotent resume contract (port of the parts of
``video_features_tpu/utils/sinks.py`` the CLI runs).

  - file name contract: ``{video_stem}_{key}{ext}`` under the (already
    namespaced) output dir;
  - sinks: ``print`` (max/mean/min summary), ``save_numpy`` (.npy),
    ``save_pickle`` (.pkl), each written atomically (temp file, fsync,
    rename);
  - :func:`is_already_exist`: every key file exists AND loads, so a file
    torn by a killed worker counts as absent and is extracted again;
  - :func:`safe_extract`: one video under the retry policy, deadline
    watchdog, decode ladder and failure journal of ``utils/faults.py``.

Telemetry (``telemetry/``, each a no-op when off): every write is a
``write`` profiler stage; with a live span each also records an
``artifact`` event with the size and sha256 of exactly the bytes renamed
into place; :func:`safe_extract` annotates the span (``decode_mode``,
``attempts``, the failure), counts retries, recoveries, demotions and
quarantine skips, and traces each attempt (``video_attempt``) and backoff
(``retry_backoff``).

The atomic write hosts the ``sink.tmp_write`` (``torn``: a truncated write,
then EIO), ``sink.fsync`` and ``sink.rename`` (``drop``: the rename is lost)
injection sites, and each attempt of :func:`safe_extract` the
``worker.kill`` site (``utils/inject.py``).
"""
from __future__ import annotations

import errno
import hashlib
import io
import os
import pickle
import tempfile
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..telemetry import trace
from . import faults, inject
from .profiling import profiler

EXTS = {"save_numpy": ".npy", "save_pickle": ".pkl"}


def make_path(output_root: str, video_path: str, output_key: str,
              ext: str) -> str:
    """``{output_root}/{stem}_{key}{ext}`` (reference utils/utils.py:53-57)."""
    return os.path.join(str(output_root),
                        f"{Path(video_path).stem}_{output_key}{ext}")


def _write_bytes_atomic(fpath: str, data: bytes) -> None:
    """Temp file in the target dir, flush + fsync, ``os.replace``; the
    temp file is removed if anything before the rename fails (an injected
    fault included)."""
    d = os.path.dirname(fpath) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(fpath) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            fault = inject.fire("sink.tmp_write", path=str(fpath))
            if fault is not None and fault.kind == "torn":
                f.write(data[:max(1, len(data) // 2)])
                f.flush()
                raise OSError(errno.EIO, f"injected torn write for {fpath}")
            f.write(data)
            f.flush()
            inject.fire("sink.fsync", path=str(fpath))
            os.fsync(f.fileno())
        fault = inject.fire("sink.rename", path=str(fpath))
        if fault is not None and fault.kind == "drop":
            raise OSError(errno.EIO, f"injected rename drop for {fpath}")
        os.replace(tmp, fpath)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write_digest(fpath: str, data: bytes,
                  want_digest: bool) -> Optional[Tuple[int, str]]:
    """Write ``data`` atomically; with ``want_digest`` return ``(bytes,
    sha256)`` of exactly what was renamed into place (hashed from memory,
    so it can never describe a file another worker replaced)."""
    _write_bytes_atomic(fpath, data)
    if want_digest:
        return len(data), hashlib.sha256(data).hexdigest()
    return None


def write_numpy(fpath: str, value, want_digest: bool = False
                ) -> Optional[Tuple[int, str]]:
    buf = io.BytesIO()
    np.save(buf, np.asarray(value))
    return _write_digest(fpath, buf.getvalue(), want_digest)


def write_pickle(fpath: str, value, want_digest: bool = False
                 ) -> Optional[Tuple[int, str]]:
    return _write_digest(fpath, pickle.dumps(value), want_digest)


def _load(on_extraction: str, fpath: str) -> None:
    if on_extraction == "save_numpy":
        np.load(fpath)
    else:
        with open(fpath, "rb") as f:
            pickle.load(f)


def is_already_exist(on_extraction: str, output_path: str, video_path: str,
                     output_feat_keys: Sequence[str]) -> bool:
    """True iff every key file exists and loads cleanly (reference
    base_extractor.py:95-127); always False for the ``print`` sink."""
    if on_extraction == "print":
        return False
    if on_extraction not in EXTS:
        raise NotImplementedError(f"on_extraction: {on_extraction}")
    existing = 0
    for key in output_feat_keys:
        fpath = make_path(output_path, video_path, key, EXTS[on_extraction])
        if not os.path.exists(fpath):
            continue
        try:
            _load(on_extraction, fpath)
            existing += 1
        except Exception:
            print(f"Failed to load: {fpath}. Will extract again.")
    if existing == len(output_feat_keys):
        print(f'Features for "{video_path}" already exist in '
              f'"{output_path}" — skipping. Use a different `output_path` '
              "to extract again.")
        return True
    return False


def action_on_extraction(feats_dict: Dict[str, np.ndarray], video_path: str,
                         output_path: str, on_extraction: str) -> None:
    """Dispatch extracted features to the configured sink (reference
    base_extractor.py:55-93)."""
    if on_extraction == "print":
        print(f"\nFeatures for: {video_path}")
        for k, v in feats_dict.items():
            arr = np.asarray(v)
            print(k)
            print(arr)
            if arr.dtype != object and arr.size > 0:
                print(f"max: {arr.max():.8f}; mean: {arr.mean():.8f}; "
                      f"min: {arr.min():.8f}")
            print()
        return
    if on_extraction not in EXTS:
        raise NotImplementedError(f"on_extraction: {on_extraction}")
    os.makedirs(output_path, exist_ok=True)
    writer = write_numpy if on_extraction == "save_numpy" else write_pickle
    span = telemetry.current_span()
    for key, value in feats_dict.items():
        if np.asarray(value).size == 0:
            print("Warning: the value is empty for", key, "@", video_path)
        fpath = make_path(output_path, video_path, key, EXTS[on_extraction])
        with profiler.stage("write"):
            info = writer(fpath, value, want_digest=span is not None)
        if info is not None:
            span.event("artifact", key=key, file=os.path.basename(fpath),
                       bytes=info[0], sha256=info[1])


def safe_extract(extract_fn: Callable, video_path: str,
                 policy: Optional[faults.RetryPolicy] = None,
                 journal: Optional[faults.FailureJournal] = None,
                 decode_mode: Optional[str] = None,
                 on_terminal_failure: Optional[Callable[[dict], None]] = None
                 ) -> str:
    """Run one video with per-video error isolation (the JAX
    ``utils/sinks.py safe_extract``; KeyboardInterrupt is re-raised):

      - a video whose latest ``journal`` record is POISON is skipped
        (``'quarantined'``) unless ``policy.retry_failed``;
      - each attempt runs inside a :class:`faults.FaultContext`: the
        ``policy.deadline_s`` watchdog cancels its in-flight decode
        sources, and after a failure under ``decode_mode`` ``parallel`` or
        ``process`` the next attempt decodes one rung down the ladder
        (``parallel -> process -> inline``);
      - each failure is classified; TRANSIENT and POISON get up to
        ``policy.attempts`` tries with the policy's backoff, FATAL fails at
        once;
      - a terminal failure appends one ``journal`` record and is passed to
        ``on_terminal_failure``;
      - a ``retry_failed`` success lifts the video's quarantine.

    ``policy=None`` is a single attempt with no deadline. Returns
    ``'done'``, ``'skipped'`` (the outputs already exist), ``'quarantined'``
    or ``'error'``."""
    if policy is None:
        policy = faults.RetryPolicy()
    telemetry.annotate(decode_mode=decode_mode)
    if journal is not None and not policy.retry_failed:
        rec = journal.poison_record(video_path)
        if rec is not None:
            print(f'"{video_path}" is quarantined by {journal.path} '
                  f'(category={rec.get("category")}, '
                  f'attempts={rec.get("attempts")}) — skipping. '
                  "Pass retry_failed=true to re-run it.")
            telemetry.inc("vft_quarantine_skips_total")
            telemetry.event("quarantine_skip", category=rec.get("category"))
            return "quarantined"

    t0 = policy.clock()
    category = None
    err_repr = ""
    attempts_made = 0
    mode = decode_mode if policy.ladder else None
    for attempt in range(1, policy.attempts + 1):
        attempts_made = attempt
        override = mode if mode is not None and mode != decode_mode else None
        ctx = faults.FaultContext(video_path, deadline_s=policy.deadline_s,
                                  decode_override=override)
        inject.fire("worker.kill", video=str(video_path), attempt=attempt)
        try:
            # one timeline span per attempt, failed ones included; it names
            # the request in scope, if any (telemetry/context.py)
            rid = telemetry.current_request_id()
            with trace.span("video_attempt", video=str(video_path),
                            attempt=attempt,
                            **({"request": rid} if rid else {})), ctx:
                result = extract_fn(video_path)
            if attempt > 1:
                print(f'Recovered "{video_path}" on attempt '
                      f"{attempt}/{policy.attempts}"
                      + (f" (video_decode={mode})" if override else ""))
                telemetry.inc("vft_video_recoveries_total")
            telemetry.annotate(attempts=attempt)
            if journal is not None and policy.retry_failed \
                    and journal.poison_record(video_path) is not None:
                journal.resolve(video_path)
            return "done" if result is not None else "skipped"
        except Exception as e:
            category = faults.classify(e)
            err_repr = f"{type(e).__name__}: {e}"
            print(f"An error occurred extracting features for: {video_path} "
                  f"(attempt {attempt}/{policy.attempts}, "
                  f"category={category})")
            traceback.print_exc()
            telemetry.event("attempt_failed", attempt=attempt,
                            category=category)
            if category == faults.FATAL:
                break
            if attempt < policy.attempts:
                next_mode = faults.demote(mode)
                if next_mode is not None:
                    print(f"DECODE LADDER: retrying \"{video_path}\" with "
                          f"video_decode={next_mode} (was {mode})")
                    telemetry.event("ladder", to=next_mode)
                    telemetry.inc("vft_decode_demotions_total")
                    mode = next_mode
                delay = policy.backoff_delay(attempt)
                telemetry.inc("vft_video_retries_total")
                if delay > 0:
                    print(f"Retrying \"{video_path}\" in {delay:.2f}s ...")
                    with trace.span("retry_backoff", video=str(video_path),
                                    attempt=attempt,
                                    delay_s=round(delay, 3)):
                        policy.sleep(delay)

    elapsed = policy.clock() - t0
    telemetry.annotate(attempts=attempts_made, category=category,
                       error=err_repr)
    rec = {"video": str(video_path), "category": category,
           "attempts": attempts_made, "error": err_repr,
           "elapsed_s": round(float(elapsed), 3)}
    if journal is not None:
        rec = journal.record(video_path, category, attempts_made, err_repr,
                             elapsed)
    if on_terminal_failure is not None:
        on_terminal_failure(rec)
    return "error"
