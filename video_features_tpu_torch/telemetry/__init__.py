"""Run-plane telemetry: metrics, per-video spans, manifest, heartbeats,
output health and the pipeline trace (port of
``video_features_tpu/telemetry/``).

  ===============================  =======================================
  ``_telemetry.jsonl``             one span record per video (spans.py,
                                   ``video_span.schema.json``)
  ``_run.json``                    the run manifest at exit (manifest.py)
  ``_heartbeat_{host_id}.json``    periodic per-worker liveness
                                   (heartbeat.py)
  ``_health.jsonl``                per-(video, family, key) feature digests
                                   (health.py, ``health=true``;
                                   ``feature_health.schema.json``)
  ``_trace.json``                  the host pipeline's timeline (trace.py,
                                   ``trace=true``)
  ``_roofline.json``               per-family FLOPs, device windows, MFU
                                   and verdict (roofline.py,
                                   ``roofline=true``;
                                   ``roofline.schema.json``)
  ``_parity.jsonl``                per-seam numerics digests (parity.py,
                                   ``parity=true``;
                                   ``parity.schema.json``)
  ``_parity_verdict.json``         a ``parity certify`` A/B verdict
                                   (``parity_verdict.schema.json``)
  ``_history_{host_id}.jsonl``     a downsampled sample of every heartbeat
                                   (history.py, ``history=true``)
  ``_alerts.jsonl``                alert transitions (alerts.py,
                                   ``alerts=true``; ``alert.schema.json``)
  ``_incidents/{alert_id}/``       a firing alert's bundle (alerts.py)
  metrics registry                 counters, gauges, fixed-bucket
                                   histograms (metrics.py), dumped into the
                                   manifest; Prometheus text export
  ===============================  =======================================

``telemetry=true`` (with ``metrics_interval_s``) turns the recorder on;
``cli.py`` owns its lifecycle. The instrumentation points in
``utils/sinks.py``, ``utils/faults.py``, ``utils/io.py``, ``cache.py``,
``parallel/`` and ``extractors/`` call the helpers below, which cost one
global (or thread-local) read when telemetry is off. The device trace is
``utils/profiling.py TraceCapture`` (``profile_trace_dir``). The readers:
``report.py`` (one run), ``alerts.py`` (the rules over a root) and
``fleet_report.py`` (a fleet's shared root).
"""
from __future__ import annotations

from typing import Any

from .context import current_request_id, use_request  # noqa: F401
from .spans import NOOP_SPAN, current_span  # noqa: F401

#: the active run's TelemetryRecorder, or None (telemetry disabled)
_active = None


def _set_active(recorder) -> None:
    global _active
    _active = recorder


def active():
    """The active :class:`~.recorder.TelemetryRecorder`, if any."""
    return _active


# -- cheap instrumentation helpers (no-ops when telemetry is off) -----------

def inc(name: str, n: float = 1.0, **labels: Any) -> None:
    """Increment a counter on the active recorder's registry."""
    r = _active
    if r is not None:
        r.registry.counter(name, **labels).inc(n)


def gauge_set(name: str, value: float, **labels: Any) -> None:
    """Set a gauge on the active recorder's registry (the fan-out queue
    depth, ``parallel/fanout.py``)."""
    r = _active
    if r is not None:
        r.registry.gauge(name, **labels).set(value)


def annotate(**kw: Any) -> None:
    """Set attributes on this thread's current video span, if any."""
    s = current_span()
    if s is not None:
        s.annotate(**kw)


def event(kind: str, **kw: Any) -> None:
    """Append a timeline event to this thread's current video span."""
    s = current_span()
    if s is not None:
        s.event(kind, **kw)
