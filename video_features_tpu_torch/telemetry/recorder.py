"""TelemetryRecorder: the run-scoped owner of every telemetry channel (port
of ``video_features_tpu/telemetry/recorder.py``).

One recorder per CLI run (``cli.py`` builds it when ``telemetry=true``):

  - owns the :class:`~.metrics.MetricsRegistry` and installs the stage
    hook on the process-global ``profiler`` (``utils/profiling.py``), so the
    ``decode``/``h2d``/``forward``/``write``/``health`` stages that already
    time the pipeline feed latency histograms and per-video spans with no
    call site of their own;
  - mints :class:`~.spans.VideoSpan` s and appends their records to
    ``{output_path}/_telemetry.jsonl``;
  - runs the heartbeat thread (``telemetry/heartbeat.py``) and writes this
    host's ``_heartbeat_{host_id}.json``, with the per-interval stage delta
    taken by ``StageProfiler.drain()`` (snapshot and reset under one lock);
  - writes the run manifest (``telemetry/manifest.py``) at :meth:`close`;
  - runs two hook points, registered before :meth:`start` so the first
    heartbeat is observed too: :attr:`extra_sections` (heartbeat sections
    rendered by callbacks, such as ``telemetry/alerts.py``'s ``alerts``) and
    :attr:`tick_hooks` (called with each heartbeat just written:
    ``telemetry/history.py`` appends its sample, ``telemetry/alerts.py``
    evaluates its rules). A failing hook is counted
    (:attr:`tick_hook_errors`) and the first failure printed; the heartbeat
    goes on.

The heartbeat's and the manifest's ``compile_cache`` sections count the
kernel build's hits (the library came from the store: no ``nvcc``) and
misses (``nvcc`` ran) since the recorder was made, with the attached
compile-cache entry's key and warmth (``compile_cache.py section``), where
the JAX recorder counts XLA's compile-cache events; the port uses no
``torch.compile``, so the ``nvcc`` build is all there is to count. The
heartbeat's ``roofline`` and ``parity`` sections are the active observers'
live snapshots (``telemetry/roofline.py``, ``telemetry/parity.py``), ``{}``
when they are off; the manifest carries the run's final roofline summary
that ``cli.py`` hands to :meth:`TelemetryRecorder.close`.

When no recorder is active every instrumentation point is a constant-time
no-op: the helpers of ``telemetry/__init__.py`` read one global, the
profiler hook is None, and ``cli.py`` hands out ``NOOP_SPAN``.
"""
from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from ..utils.profiling import StageProfiler, profiler
from . import jsonl, manifest
from .heartbeat import HeartbeatThread, heartbeat_filename
from .metrics import FPS_BUCKETS, LATENCY_BUCKETS, MetricsRegistry
from .spans import VideoSpan, current_span

SPANS_FILENAME = "_telemetry.jsonl"


class TelemetryRecorder:
    """Run-scoped telemetry: construct, :meth:`start`, hand out spans,
    :meth:`close` in a ``finally``."""

    def __init__(self, output_path: str, *,
                 run_config: Optional[dict] = None,
                 feature_type: Optional[str] = None,
                 interval_s: float = 30.0,
                 host_id: Optional[str] = None,
                 compile_cache_baseline: Optional[dict] = None) -> None:
        self.output_path = str(output_path)
        self.run_config = run_config
        self.feature_type = feature_type
        self.interval_s = float(interval_s)
        self.host_id = host_id or socket.gethostname()
        # stamped into the manifest and every heartbeat, so report tools
        # can tell this run's heartbeats from stale files an earlier run
        # left in the same output_path
        self.run_id = uuid.uuid4().hex[:12]
        self.registry = MetricsRegistry()
        self.spans_path = os.path.join(self.output_path, SPANS_FILENAME)
        self.heartbeat_path = os.path.join(
            self.output_path, heartbeat_filename(self.host_id))
        self.manifest_path = os.path.join(
            self.output_path, manifest.MANIFEST_FILENAME)
        # run-long stage totals (manifest) and the per-interval delta
        # (heartbeat, drained each tick)
        self._run_stages = StageProfiler()
        self._delta_stages = StageProfiler()
        self._hb = HeartbeatThread(self._tick, self.interval_s)
        self._state_lock = threading.Lock()
        self._last_video: Optional[str] = None
        self._status_counts: Dict[str, int] = {}
        # output-health roll-up (telemetry/health.py digest_features feeds
        # it): per-family record / NaN / Inf totals for the manifest
        self._health: Dict[str, Dict[str, int]] = {}
        self._t0 = time.perf_counter()
        self._start_time = time.time()
        self._closed = False
        # the kernel build's counts at the start of the run (the caller's,
        # taken before its compile-cache attach built the kernels): the
        # sections report the delta
        from .. import compile_cache
        self._cc_baseline = (dict(compile_cache_baseline)
                             if compile_cache_baseline is not None
                             else compile_cache.snapshot())
        # {section name: zero-argument callable -> JSON-safe value}, each
        # rendered into every heartbeat; a failed callback renders
        # {"error": ...}
        self.extra_sections: Dict[str, Callable[[], dict]] = {}
        # called with each heartbeat just written (history, alerts)
        self.tick_hooks: List[Callable[[dict], None]] = []
        self.tick_hook_errors = 0
        # a failed _telemetry.jsonl append (ENOSPC) turns the span channel
        # off for the rest of the run
        self._spans_disabled = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "TelemetryRecorder":
        from . import _set_active
        os.makedirs(self.output_path, exist_ok=True)
        _set_active(self)
        profiler.set_hook(self._observe_stage)
        self.write_heartbeat()  # liveness visible before the first video
        self._hb.start()
        return self

    def close(self, *, tally: Optional[Dict[str, int]] = None,
              wall_s: Optional[float] = None,
              failure_tallies: Optional[Dict[str, int]] = None,
              roofline: Optional[dict] = None) -> None:
        """Stop the heartbeat thread, write a final heartbeat and the run
        manifest (with ``roofline``, the run's final MFU summary, ``{}``
        when roofline is off). Idempotent; never raises into the caller's
        finally."""
        if self._closed:
            return
        self._closed = True
        from . import _set_active
        self._hb.stop()
        profiler.set_hook(None)
        _set_active(None)
        try:
            self.write_heartbeat(final=True)
            jsonl.write_json_atomic(self.manifest_path, self.build_manifest(
                tally=tally, wall_s=wall_s, failure_tallies=failure_tallies,
                roofline=roofline))
        except Exception as e:
            print(f"telemetry: failed to write {self.manifest_path}: "
                  f"{type(e).__name__}: {e}")

    # -- spans --------------------------------------------------------------
    def video_span(self, video: str,
                   feature_type: Optional[str] = None) -> VideoSpan:
        # multi-family runs share one recorder but stamp each span with
        # its own family, so per-(video, family) records stay queryable
        return VideoSpan(video, recorder=self,
                         feature_type=feature_type or self.feature_type,
                         host_id=self.host_id)

    def emit_span(self, record: dict) -> None:
        if not self._spans_disabled:
            try:
                jsonl.append_jsonl(self.spans_path, record)
            except OSError as e:
                # a full or read-only disk degrades this channel, not the
                # extraction: no more spans this run, the counters go on
                self._spans_disabled = True
                self.registry.counter("vft_telemetry_write_failures_total",
                                      pillar="spans").inc()
                print(f"telemetry: failed to append {self.spans_path} "
                      f"({type(e).__name__}: {e}) — span channel disabled "
                      "for this run")
        status = record.get("status", "?")
        self.registry.counter("vft_videos_total", status=status).inc()
        self.registry.histogram("vft_video_wall_seconds",
                                buckets=LATENCY_BUCKETS).observe(
                                    record.get("wall_s") or 0.0)
        frames, wall = record.get("video_frames"), record.get("wall_s")
        if frames and wall:
            self.registry.histogram("vft_video_processed_fps",
                                    buckets=FPS_BUCKETS).observe(
                                        frames / wall)
        with self._state_lock:
            self._last_video = record.get("video")
            self._status_counts[status] = \
                self._status_counts.get(status, 0) + 1

    # -- output health (telemetry/health.py) ---------------------------------
    def health_observe(self, rec: dict) -> None:
        """Fold one feature digest into the per-family manifest roll-up."""
        fam = str(rec.get("feature_type") or "?")
        nonfinite = int(rec.get("nan", 0)) + int(rec.get("inf", 0))
        with self._state_lock:
            h = self._health.setdefault(
                fam, {"records": 0, "nonfinite_records": 0,
                      "nan": 0, "inf": 0})
            h["records"] += 1
            h["nan"] += int(rec.get("nan", 0))
            h["inf"] += int(rec.get("inf", 0))
            if nonfinite:
                h["nonfinite_records"] += 1

    def health_summary(self) -> Dict[str, Dict[str, int]]:
        with self._state_lock:
            return {f: dict(v) for f, v in self._health.items()}

    # -- stage hook (installed on the global profiler) -----------------------
    def _observe_stage(self, name: str, dt: float) -> None:
        self.registry.histogram("vft_stage_seconds", buckets=LATENCY_BUCKETS,
                                stage=name).observe(dt)
        self._run_stages.add(name, dt)
        self._delta_stages.add(name, dt)
        span = current_span()
        if span is not None:
            span.observe_stage(name, dt)

    # -- heartbeats ----------------------------------------------------------
    def _tick(self) -> None:
        self.write_heartbeat()

    def build_heartbeat(self, final: bool = False) -> dict:
        uptime = time.perf_counter() - self._t0
        with self._state_lock:
            status_counts = dict(self._status_counts)
            last_video = self._last_video
        done = sum(status_counts.values())
        vps = round(status_counts.get("done", 0) / uptime, 4) if uptime \
            else 0.0
        self.registry.gauge("vft_videos_per_second").set(vps)
        self.registry.gauge("vft_uptime_seconds").set(round(uptime, 3))
        # drain(): snapshot and reset at once, the per-interval delta a
        # scraper can turn into rates without double counting
        delta = {k: {"s": round(v[0], 6), "calls": v[1]}
                 for k, v in self._delta_stages.drain().items()}
        hb = {
            "schema": "vft.heartbeat/1",
            "run_id": self.run_id,
            "host": socket.gethostname(),
            "host_id": self.host_id,
            "pid": os.getpid(),
            "feature_type": self.feature_type,
            "time": round(time.time(), 3),
            "started_time": round(self._start_time, 3),
            "uptime_s": round(uptime, 3),
            "interval_s": self.interval_s,
            "final": bool(final),
            "videos": status_counts,
            "videos_done": done,
            "videos_per_s": vps,
            "last_video": last_video,
            # a host whose ticks were failing looks dead to the fleet; the
            # next successful write carries the evidence
            "tick_errors": int(self._hb.tick_errors_total),
            "last_tick_error": self._hb.last_tick_error,
            "stage_delta": delta,
            # fan-out backpressure (parallel/fanout.py): which family is
            # the slow consumer (its queue runs full, put_blocked grows)
            # or the starved one (get_starved grows)
            "fanout": self.fanout_snapshot(),
            # feature-cache effectiveness (cache.py): per-family hit, miss
            # and bypass totals and the hit rate
            "cache": self.cache_snapshot(),
            # the kernel build's hits and misses this run, and the attached
            # compile-cache entry's key and warmth (compile_cache.py)
            "compile_cache": self.compile_cache_snapshot(),
            # per-family MFU and verdict, live; {} when roofline=false
            "roofline": self.roofline_snapshot(),
            # per-seam record tallies, live; {} when parity=false
            "parity": self.parity_snapshot(),
        }
        for name, fn in list(self.extra_sections.items()):
            try:
                hb[name] = fn()
            except Exception:
                hb[name] = {"error": "section callback failed"}
        return hb

    def compile_cache_snapshot(self) -> dict:
        """The kernel build's hits and misses since the run started, and
        the attached entry's identity and verify verdicts: ``hits > 0,
        misses == 0`` is the warm-join shape. Never raises."""
        try:
            from .. import compile_cache
            return compile_cache.section(self._cc_baseline)
        except Exception:
            return {}

    def roofline_snapshot(self) -> dict:
        """The active roofline observer's light per-family summary, ``{}``
        when roofline is off; never raises (a heartbeat tick must not
        fail on it)."""
        try:
            from . import roofline
            return roofline.snapshot()
        except Exception:
            return {}

    def parity_snapshot(self) -> dict:
        """The active parity observer's per-seam record tallies, ``{}``
        when parity is off."""
        try:
            from . import parity
            return parity.snapshot()
        except Exception:
            return {}

    def _by_family(self, key_of: Dict[str, str], value) -> dict:
        """``{key_of[name]: {family: value(series)}}`` over the registry's
        series named in ``key_of`` that carry a ``family`` label."""
        out: Dict[str, Dict[str, float]] = {k: {} for k in key_of.values()}
        for s in self.registry.to_dict()["series"]:
            key = key_of.get(s["name"])
            fam = s.get("labels", {}).get("family")
            if key is not None and fam is not None:
                out[key][fam] = value(s)
        return out

    def cache_snapshot(self) -> dict:
        """Per-family feature-cache counters: ``{hits, misses, bypasses}``
        each ``{family: n}``, and the ``hit_rate`` over consulted lookups
        (hits + misses; a filename skip avoided work without consulting the
        cache, so it does not dilute the rate)."""
        out = self._by_family({"vft_cache_hit_total": "hits",
                               "vft_cache_miss_total": "misses",
                               "vft_cache_bypass_total": "bypasses"},
                              lambda s: int(s.get("value", 0)))
        hits = sum(out["hits"].values())
        consulted = hits + sum(out["misses"].values())
        out["hit_rate"] = round(hits / consulted, 4) if consulted else None
        return out

    def fanout_snapshot(self) -> dict:
        """Per-family fan-out backpressure: ``{queue_depth,
        put_blocked_ms_total, get_starved_ms_total}``, each ``{family:
        value}`` (empty outside multi-family runs)."""
        return self._by_family(
            {"vft_fanout_queue_depth": "queue_depth",
             "vft_fanout_put_blocked_ms_total": "put_blocked_ms_total",
             "vft_fanout_get_starved_ms_total": "get_starved_ms_total"},
            lambda s: round(float(s.get("value", 0.0)), 3))

    def write_heartbeat(self, final: bool = False) -> None:
        hb = self.build_heartbeat(final=final)
        jsonl.write_json_atomic(self.heartbeat_path, hb)
        for fn in list(self.tick_hooks):
            try:
                fn(hb)
            except Exception as e:
                # a hook observes: it never breaks liveness, but a silently
                # dead retention or alerting channel is its own incident
                self.tick_hook_errors += 1
                if self.tick_hook_errors == 1:
                    print(f"telemetry: heartbeat hook failed: "
                          f"{type(e).__name__}: {e}")

    # -- manifest ------------------------------------------------------------
    def build_manifest(self, *, tally: Optional[Dict[str, int]] = None,
                       wall_s: Optional[float] = None,
                       failure_tallies: Optional[Dict[str, int]] = None,
                       roofline: Optional[dict] = None) -> dict:
        with self._state_lock:
            tally = dict(tally if tally is not None else self._status_counts)
        stage_totals = {k: {"s": round(v[0], 6), "calls": v[1]}
                        for k, v in self._run_stages.snapshot().items()}
        return manifest.build_manifest(
            run_config=self.run_config,
            feature_type=self.feature_type,
            host_id=self.host_id,
            run_id=self.run_id,
            health=self.health_summary(),
            started_time=round(self._start_time, 3),
            wall_s=wall_s if wall_s is not None
            else time.perf_counter() - self._t0,
            tally=tally,
            failure_tallies=failure_tallies,
            stage_totals=stage_totals,
            metrics_dump=self.registry.to_dict(),
            roofline=roofline,
            compile_cache=self.compile_cache_snapshot())
