"""Crash-safe JSON file primitives shared by every telemetry artifact (port
of ``video_features_tpu/telemetry/jsonl.py``).

  - :func:`append_jsonl`: one ``os.write`` on an ``O_APPEND`` fd per
    record, so concurrent writers sharing an output dir never interleave
    partial lines, first healing a torn tail left by a killed writer with a
    newline (only the already-torn record is lost);
  - :func:`write_json_atomic`: temp file in the same directory, flush,
    fsync, ``os.replace``: a reader never sees a half-written manifest,
    heartbeat or trace;
  - :func:`read_jsonl`: skips corrupt lines instead of failing, since
    telemetry is an observation channel, never a lock.

``_failures.jsonl`` (``utils/faults.py``), ``_telemetry.jsonl``,
``_health.jsonl``, ``_run.json``, the heartbeats and ``_trace.json`` all
go through these.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Iterator, Union

PathLike = Union[str, os.PathLike]


def append_jsonl(path: PathLike, rec: dict) -> None:
    """Append one record as a single atomic ``os.write``, healing a torn
    tail left by a previously killed writer."""
    path = str(path)
    line = (json.dumps(rec, sort_keys=True) + "\n").encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        try:
            if os.fstat(fd).st_size > 0:
                with open(path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        line = b"\n" + line
        except OSError:
            pass
        os.write(fd, line)
    finally:
        os.close(fd)


def read_jsonl(path: PathLike) -> Iterator[dict]:
    """Yield every parseable dict record; corrupt lines are skipped and a
    missing file yields nothing."""
    try:
        f = open(str(path), encoding="utf-8", errors="replace")
    except OSError:
        return
    with f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except (json.JSONDecodeError, ValueError):
                continue
            if isinstance(rec, dict):
                yield rec


def write_json_atomic(path: PathLike, obj: dict, indent: int = 2) -> None:
    """Write ``obj`` as JSON via temp file + fsync + ``os.replace``; the
    temp file is removed if anything before the rename fails."""
    path = str(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=indent, sort_keys=True, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
