"""Multi-host heartbeats: periodic liveness files in the shared output dir
(port of ``video_features_tpu/telemetry/heartbeat.py``).

Each worker writes ``{output_path}/_heartbeat_{host_id}.json`` every
``metrics_interval_s`` seconds (atomic replace, ``telemetry/jsonl.py``), so
an operator (``python -m video_features_tpu_torch.telemetry.report``, or
``python -m video_features_tpu_torch.fleet_report`` over a fleet's shared
root) can tell a slow host from a dead one without logging in: a heartbeat
older than :data:`STALL_INTERVALS` intervals means the worker stalled or
died, and its ``last_video`` names the suspect input. Hosts never talk to each other (the work list is split
by ``parallel/mesh.py local_shard_of_list``); they only share an output
directory.

The writer thread is a daemon; ticks call back into the recorder, which
owns the file's contents (``telemetry/recorder.py build_heartbeat``). Each
tick fires the ``heartbeat.tick`` injection site (``utils/inject.py``):
``freeze`` skips the tick silently, a raise-kind fault exercises the tick
error accounting.
"""
from __future__ import annotations

import re
import threading
from typing import Callable, Optional

HEARTBEAT_PREFIX = "_heartbeat_"
HEARTBEAT_GLOB = HEARTBEAT_PREFIX + "*.json"

#: a heartbeat older than this many intervals marks the host STALLED
STALL_INTERVALS = 3.0


def heartbeat_filename(host_id: str) -> str:
    """``_heartbeat_{host_id}.json`` with the id sanitized for the
    filesystem (host ids embed hostnames)."""
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(host_id))
    return f"{HEARTBEAT_PREFIX}{safe}.json"


def matches_run(heartbeat: dict, run_id: Optional[str],
                started_time: Optional[float] = None) -> bool:
    """False iff this heartbeat demonstrably belongs to a run older than
    ``run_id`` (the manifest's): output dirs are reused, and a worker that
    died without a final heartbeat leaves its file behind, which the
    report tools must not count as a worker of the current run.

    Each host mints its own run id, so a fleet sharing one dir shows
    several; a mismatched id marks staleness only when the heartbeat also
    predates the manifest's ``started_time``. A missing id on either side
    matches (an unprovable mismatch stays visible)."""
    hb_run = heartbeat.get("run_id")
    if run_id is None or hb_run is None or str(hb_run) == str(run_id):
        return True
    if started_time is None:
        return False
    hb_time = heartbeat.get("time")
    try:
        return hb_time is not None and float(hb_time) >= float(started_time)
    except (TypeError, ValueError):
        return False


class HeartbeatThread:
    """Fires ``tick()`` every ``interval_s`` until :meth:`stop`.

    ``Event.wait(interval)`` (not ``sleep``) so stop() interrupts a wait
    immediately — worker shutdown must not dangle for up to a full
    metrics interval.

    Tick failures are **counted, never swallowed silently**: a
    persistently-failing tick stops refreshing the heartbeat file, which
    to the fleet is indistinguishable from a dead host. The accounting
    (:attr:`tick_errors_total`, :attr:`consecutive_errors`,
    :attr:`last_tick_error`) is exported as
    ``vft_heartbeat_tick_errors_total`` and surfaced inside the next
    *successful* heartbeat (telemetry/recorder.py ``build_heartbeat``),
    so an operator reading the file sees "this host is alive but its
    liveness channel was failing" instead of nothing at all.
    """

    def __init__(self, tick: Callable[[], None], interval_s: float) -> None:
        if float(interval_s) <= 0:
            raise ValueError(
                f"metrics_interval_s={interval_s}: need > 0")
        self._tick = tick
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tick_errors_total = 0
        self.consecutive_errors = 0
        self.last_tick_error: Optional[str] = None
        self.frozen_ticks = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="vft-heartbeat", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from ..utils import inject
        while not self._stop.wait(self.interval_s):
            try:
                # chaos hook (utils/inject.py `heartbeat.tick`): `freeze`
                # silently skips ticks — the host looks dead while its
                # work continues (the lease-steal-of-a-live-host case);
                # raise-kind faults exercise the error accounting below
                fault = inject.fire("heartbeat.tick")
                if fault is not None and fault.kind == "freeze":
                    self.frozen_ticks += 1
                    continue
                self._tick()
                self.consecutive_errors = 0
            except Exception as e:
                # liveness reporting must never kill (or be killed by)
                # the extraction it observes — but a failing tick is
                # itself a liveness event: count it, export it, and keep
                # the last error for the next successful heartbeat
                self.tick_errors_total += 1
                self.consecutive_errors += 1
                self.last_tick_error = f"{type(e).__name__}: {e}"
                try:
                    from .. import telemetry
                    telemetry.inc("vft_heartbeat_tick_errors_total")
                except Exception:
                    pass
                if self.consecutive_errors == 1 or \
                        self.consecutive_errors % 10 == 0:
                    print(f"heartbeat: tick failed ({self.last_tick_error}); "
                          f"{self.consecutive_errors} consecutive failure(s)"
                          " — this host will look STALLED to the fleet if "
                          "they persist")

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None
