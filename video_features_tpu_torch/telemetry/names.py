"""The metric-name registry: every ``vft_*`` series, declared once (port of
``video_features_tpu/telemetry/names.py``, the same names and kinds).

Emitters (the helpers of ``telemetry/__init__.py``, ``recorder.py``, the
cache, fan-out and fault counters), heartbeat sections and the Prometheus
export are joined by nothing but string equality; this table is the one
place a name is spelled. ``kind`` is the Prometheus type, and counters end
in ``_total``. Series whose planes the port does not run yet (serving, the
fleet queue, the gateway, load generation, roofline, parity, storage) keep
their entries, so the two packages' registries stay equal and a ported
plane finds its names here. Dependency-free.
"""
from __future__ import annotations

#: name -> Prometheus kind ("counter" | "gauge" | "histogram")
METRICS = {
    # -- run lifecycle (telemetry/recorder.py) ------------------------------
    "vft_videos_total": "counter",
    "vft_video_wall_seconds": "histogram",
    "vft_video_processed_fps": "histogram",
    "vft_stage_seconds": "histogram",
    "vft_videos_per_second": "gauge",
    "vft_uptime_seconds": "gauge",

    # -- fault tolerance (utils/faults.py, utils/sinks.py) ------------------
    "vft_failures_total": "counter",
    "vft_video_retries_total": "counter",
    "vft_video_recoveries_total": "counter",
    "vft_decode_demotions_total": "counter",
    "vft_deadline_expirations_total": "counter",
    "vft_quarantine_skips_total": "counter",

    # -- shared-decode fan-out (parallel/fanout.py) -------------------------
    "vft_fanout_queue_depth": "gauge",
    "vft_fanout_put_blocked_ms_total": "counter",
    "vft_fanout_get_starved_ms_total": "counter",
    "vft_fanout_decode_errors_total": "counter",

    # -- output health (telemetry/health.py) --------------------------------
    "vft_health_nonfinite_total": "counter",

    # -- heartbeat flusher (telemetry/heartbeat.py) -------------------------
    "vft_heartbeat_tick_errors_total": "counter",

    # -- feature cache (cache.py via extractors/base.py, multi.py) ----------
    "vft_cache_hit_total": "counter",
    "vft_cache_miss_total": "counter",
    "vft_cache_bypass_total": "counter",
    "vft_cache_store_failures_total": "counter",

    # -- fleet queue (parallel/queue.py) ------------------------------------
    "vft_fleet_claimed_total": "counter",
    "vft_fleet_stolen_total": "counter",
    "vft_fleet_reclaimed_total": "counter",
    "vft_fleet_requeued_total": "counter",
    "vft_fleet_quarantined_total": "counter",

    # -- chaos plane (utils/inject.py) --------------------------------------
    "vft_inject_fired_total": "counter",

    # -- serve mode (serve.py) ----------------------------------------------
    "vft_serve_queue_wait_seconds": "histogram",
    "vft_serve_service_seconds": "histogram",
    "vft_serve_slo_violations_total": "counter",
    "vft_serve_deadline_exceeded_total": "counter",
    "vft_serve_reclaimed_total": "counter",
    "vft_tenant_requests_total": "counter",
    "vft_tenant_slo_violations_total": "counter",
    "vft_tenant_rejects_total": "counter",

    # -- gateway ingress (gateway.py) ---------------------------------------
    "vft_gateway_requests_total": "counter",
    "vft_gateway_upload_stored_total": "counter",
    "vft_gateway_upload_dedup_total": "counter",

    # -- fleet aggregator exports (fleet_report.py --prom): gauge samples
    #    of the fleet-wide roll-up; *_total names are sums of the
    #    per-host counters above and keep counter semantics
    "vft_fleet_hosts": "gauge",
    "vft_fleet_videos_done": "gauge",
    "vft_fleet_videos_per_s": "gauge",
    "vft_fleet_straggler": "gauge",
    "vft_fleet_queue_items": "gauge",
    "vft_fleet_cache_hits_total": "counter",
    "vft_fleet_cache_misses_total": "counter",
    "vft_fleet_cache_bypasses_total": "counter",
    "vft_fleet_cache_hit_rate": "gauge",
    "vft_fleet_compile_cache_hits_total": "counter",
    "vft_fleet_compile_cache_misses_total": "counter",
    "vft_fleet_compile_cache_hit_rate": "gauge",
    "vft_fleet_compile_cache_warm_hosts": "gauge",
    "vft_fleet_capacity_recommendation": "gauge",
    "vft_fleet_capacity_pressure": "gauge",
    "vft_fleet_capacity_pending_per_host": "gauge",
    "vft_fleet_capacity_idle_share": "gauge",
    "vft_fleet_family_done": "gauge",
    "vft_fleet_family_errors": "gauge",
    "vft_fleet_family_s_per_video": "gauge",
    "vft_fleet_serve_requests_total": "counter",
    "vft_fleet_serve_slo_violations_total": "counter",
    "vft_fleet_serve_slo_attainment_pct": "gauge",
    "vft_fleet_serve_service_seconds": "gauge",
    "vft_fleet_serve_queue_wait_seconds": "gauge",
    "vft_tenant_slo_attainment_pct": "gauge",

    # -- traffic scenarios (loadgen.py; vft-fleet == scenarios == + --prom) -
    "vft_loadgen_offered_total": "counter",
    "vft_loadgen_admitted_total": "counter",
    "vft_loadgen_rejected_total": "counter",
    "vft_loadgen_shed_total": "counter",
    "vft_loadgen_completed_total": "counter",
    "vft_loadgen_expired_total": "counter",
    "vft_scenario_pass": "gauge",
    "vft_scenario_offered": "gauge",
    "vft_scenario_admitted": "gauge",
    "vft_scenario_completed": "gauge",
    "vft_scenario_expired": "gauge",
    "vft_scenario_rejected": "gauge",
    "vft_scenario_shed": "gauge",
    "vft_scenario_attainment_pct": "gauge",

    # -- parity observatory (telemetry/parity.py; vft-fleet == parity ==) ---
    "vft_parity_records_total": "counter",
    "vft_parity_seam_error": "gauge",
    "vft_parity_verdict_pass": "gauge",

    # -- roofline observatory (telemetry/roofline.py via vft-fleet) ---------
    "vft_roofline_mfu": "gauge",
    "vft_roofline_effective_tflops": "gauge",
    "vft_roofline_dispatches_total": "counter",
    "vft_roofline_peak_tflops": "gauge",

    # -- telemetry writer self-health (recorder/history/trace pillars) ------
    "vft_telemetry_write_failures_total": "counter",

    # -- storage lifecycle plane (gc.py via vft-gc / vft-fleet) -------------
    "vft_gc_plane_bytes": "gauge",
    "vft_gc_tenant_bytes": "gauge",
    "vft_gc_used_bytes": "gauge",
    "vft_gc_quota_bytes": "gauge",
    "vft_gc_evicted_total": "counter",
    "vft_gc_evicted_bytes_total": "counter",
    "vft_gc_retained_total": "counter",
    "vft_gc_sweeps_total": "counter",
    "vft_gc_sweep_errors_total": "counter",
}

