"""Alerting and the flight recorder: the plane that watches the telemetry
(port of ``video_features_tpu/telemetry/alerts.py``).

The run plane records; this module evaluates, in three steps:

  **evaluate**: a declarative rule engine (:data:`BUILTIN_RULES`) runs on
  the heartbeat cadence over artifacts alone: heartbeat states, the
  ``_queue`` directories, the certify verdicts and the retained history
  series (``telemetry/history.py``) that the windowed rules (multi-window
  SLO burn rates, spike deltas, MFU against the family's own history) diff.

  **alert**: each (rule, scope) is a pending -> firing -> resolved state
  machine with dedup: transitions append to ``{root}/_alerts.jsonl``
  under ``alert.schema.json``; steady states emit nothing. The journal is
  the engine's state: any evaluator (the recorder hook of an
  ``alerts=true`` run, a one-shot ``python -m
  video_features_tpu_torch.telemetry.alerts ROOT`` from cron, or its
  ``--watch``) rebuilds the open episodes from the last record per (rule,
  scope), so a one-shot resolves an alert a long-dead run fired. Pending
  and firing alerts render in ``telemetry/report.py`` and
  ``fleet_report.py`` and export as Prometheus ``ALERTS`` gauges.

  **capture**: when a rule fires, an incident bundle lands under
  ``{root}/_incidents/{alert_id}/``: the heartbeats, the tails of every
  failure, span, health, alert and history journal, a stitched trace
  window, the ``_queue`` counts and the roofline roll-up, with a
  ``manifest.json`` of every artifact's size and sha256.

``alerts=true`` (which implies ``history=true``) turns it on for a
``telemetry=true`` run; ``alerts=false`` leaves the artifacts as they were
without it. The rules that read the fleet queue, serving, tenants, the
compile cache and storage read the JAX package's on-disk layout (the
``_queue`` directories, the heartbeat's ``fleet``, ``serve``,
``compile_cache`` and ``gc`` sections), which the port's queue, server,
compile cache and storage monitor write (the ``gc`` section with
``gc=true``, ``gc.py GcMonitor``; ``disk_pressure`` reads its samples in
the retained history). Rule failures are counted
(:attr:`AlertEngine.eval_errors`) and published in the heartbeat's
``alerts`` section; the run goes on.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
import uuid
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import history, jsonl

ALERTS_FILENAME = "_alerts.jsonl"
INCIDENTS_DIRNAME = "_incidents"

SCHEMA_VERSION = "vft.alert/1"
INCIDENT_SCHEMA = "vft.incident/1"
ALERT_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                                 "alert.schema.json")

#: every key an alert record carries; alert.schema.json lists exactly these
ALERT_FIELDS = ("schema", "alert_id", "rule", "severity", "state", "scope",
                "summary", "value", "threshold", "since", "time", "run_id",
                "incident")

STATES = ("pending", "firing", "resolved")
SEVERITIES = ("page", "ticket")


def load_alert_schema() -> dict:
    with open(ALERT_SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def validate_alert(rec: dict) -> List[str]:
    from .schema import validate
    return validate(rec, load_alert_schema())


# -- configuration ------------------------------------------------------------

@dataclass(frozen=True)
class AlertConfig:
    """Rule thresholds and window widths. Defaults target the serve
    SLO discipline (95% attainment, Google-SRE-style multi-window burn)
    and the fleet's own knobs (``fleet_max_reclaims=3``); every field
    is overridable from the CLI's flags or engine construction."""

    #: SLO attainment objective (%); error budget = 1 - target/100
    slo_target_pct: float = 95.0
    #: burn-rate trip point: 1.0 = consuming budget exactly as fast as
    #: the objective allows; > 1 exhausts it early
    burn_threshold: float = 1.0
    #: the short (fast-burn) and long (sustained-burn) windows — BOTH
    #: must exceed burn_threshold, so a single slow request can't page
    #: but a sustained burn still fires within short_window_s
    short_window_s: float = 300.0
    long_window_s: float = 3600.0
    #: requests required inside the short window before burn is judged
    min_requests: int = 1
    #: shared window for spike/growth/collapse rules
    spike_window_s: float = 600.0
    #: queue-depth trip point, per live host (the CapacityPlanner's own)
    up_pending_per_host: float = 2.0
    #: windowed lease reclaims before alerting (= fleet_max_reclaims)
    reclaim_spike: int = 3
    #: windowed quarantines before alerting (any is pathological)
    quarantine_spike: int = 1
    #: windowed terminal failures (error + quarantined videos)
    failure_spike: int = 1
    #: cache collapse: windowed hit rate below collapse_factor x the
    #: cumulative rate, with at least min_lookups in the window and a
    #: cumulative rate worth defending
    cache_min_lookups: int = 20
    compile_min_lookups: int = 4
    collapse_factor: float = 0.5
    min_baseline_rate: float = 0.25
    #: MFU regression vs the family's OWN history: current below
    #: mfu_regression_frac x median of >= mfu_min_history prior samples
    mfu_regression_frac: float = 0.7
    mfu_min_history: int = 3
    #: disk pressure (the heartbeat's gc usage samples): fire at this
    #: fraction of the quota, or when the windowed growth rate projects
    #: the quota full within the horizon
    disk_pressure_frac: float = 0.9
    disk_horizon_s: float = 3600.0


# -- rules --------------------------------------------------------------------

@dataclass(frozen=True)
class AlertRule:
    """One declarative rule: ``evaluate(obs, cfg)`` returns the scopes
    currently violating it. ``for_s`` is the pending dwell before a
    violation fires (0 = the condition's own windows are the damping);
    ``clear_for_s`` is honored by long-running engines only — a
    journal-reconstructed one-shot resolves immediately."""
    name: str
    severity: str
    description: str
    evaluate: Callable[[dict, AlertConfig], List[dict]]
    for_s: float = 0.0
    clear_for_s: float = 0.0


def _finding(scope: str, summary: str, value=None,
             threshold=None) -> dict:
    return {"scope": str(scope), "summary": str(summary),
            "value": (round(float(value), 4) if value is not None
                      else None),
            "threshold": (round(float(threshold), 4)
                          if threshold is not None else None)}


def _rule_slo_burn(obs: dict, cfg: AlertConfig) -> List[dict]:
    """Multi-window SLO burn: the windowed violation rate of the serve
    latency objective (``serve_slo_s``, measured on the queue-wait +
    service histograms) divided by the error budget. Fires only when
    BOTH the short and the long window burn >= threshold — fast enough
    to catch a real burn inside short_window_s, damped enough that one
    slow request against a quiet hour stays silent.

    With per-tenant tallies retained (heartbeat
    ``serve.tenants``, sampled by telemetry/history.py), the same
    two-window test additionally runs per tenant, scoped
    ``{host}/tenant={name}`` — one noisy tenant burning ITS budget
    pages as that tenant, not as the host."""
    out: List[dict] = []
    now = obs["time"]
    budget = max(1e-6, 1.0 - cfg.slo_target_pct / 100.0)

    def burn(samples, num_path: str, den_path: str):
        short = history.window_rate(samples, num_path, den_path, now,
                                    cfg.short_window_s)
        if short is None or short[1] < cfg.min_requests:
            return None
        long_ = history.window_rate(samples, num_path, den_path, now,
                                    cfg.long_window_s) or short
        burn_s, burn_l = short[2] / budget, long_[2] / budget
        if burn_s >= cfg.burn_threshold and burn_l >= cfg.burn_threshold:
            return short, burn_s, burn_l
        return None

    for host, samples in sorted(obs["history"].items()):
        hit = burn(samples, "slo.violations", "slo.requests")
        if hit is not None:
            short, burn_s, burn_l = hit
            out.append(_finding(
                host,
                f"SLO burn rate {burn_s:.2f}x budget over "
                f"{cfg.short_window_s:.0f}s ({int(short[0])}/"
                f"{int(short[1])} requests violating; long window "
                f"{burn_l:.2f}x)",
                value=burn_s, threshold=cfg.burn_threshold))
        tenants = (samples[-1].get("tenants") or {}) if samples else {}
        for t in sorted(tenants):
            hit = burn(samples, f"tenants.{t}.violations",
                       f"tenants.{t}.requests")
            if hit is not None:
                short, burn_s, burn_l = hit
                out.append(_finding(
                    f"{host}/tenant={t}",
                    f"tenant {t}: SLO burn rate {burn_s:.2f}x budget "
                    f"over {cfg.short_window_s:.0f}s ({int(short[0])}/"
                    f"{int(short[1])} requests violating; long window "
                    f"{burn_l:.2f}x)",
                    value=burn_s, threshold=cfg.burn_threshold))
    return out


def _rule_host_stalled(obs: dict, cfg: AlertConfig) -> List[dict]:
    """A host whose heartbeat is silent past the stall window. When
    claim tracking exists (a fleet ``_queue`` or serve spool), the
    alert scopes to *stalled while holding leases* — it resolves the
    moment siblings reclaim them (the fleet healed around the corpse),
    which is also how a SIGKILLed host's alert ever resolves. A plain
    batch host (no claim dirs) alerts on staleness alone and resolves
    when its heartbeat refreshes or goes final."""
    out: List[dict] = []
    claims = obs.get("claims") or {}
    tracked = obs.get("claims_tracked", False)
    for e in obs["hosts"]:
        hb = e.get("hb")
        if hb is None or e.get("prior_run") or e["state"] != "STALLED":
            continue
        host = str(hb.get("host_id"))
        held = claims.get(_safe_scope(host))
        if tracked and not held:
            continue  # leases reclaimed (or never held): fleet healed
        age = e.get("age_s")
        summary = (f"heartbeat silent for {age:.0f}s"
                   if age is not None else "heartbeat silent")
        if held:
            summary += f" while holding {held} claim(s)"
        out.append(_finding(host, summary, value=age))
    return out


def _rule_queue_growth(obs: dict, cfg: AlertConfig) -> List[dict]:
    """Backlog growing faster than the fleet drains it: pending depth
    at or past the per-host trip point AND (when history exists) not
    shrinking over the window."""
    q = obs.get("queue")
    if not isinstance(q, dict):
        return []
    pending = int(q.get("pending") or 0)
    live = max(1, int(obs.get("n_live") or 0))
    per_host = pending / live
    if per_host < cfg.up_pending_per_host:
        return []
    now = obs["time"]
    growth = None
    for samples in obs["history"].values():
        d = history.window_delta(samples, "fleet.queue.pending", now,
                                 cfg.spike_window_s,
                                 allow_negative=True)  # depth is a gauge
        if d is not None:
            growth = max(growth, d[0]) if growth is not None else d[0]
    if growth is not None and growth <= 0:
        return []  # deep but draining: capacity is catching up
    return [_finding(
        "fleet",
        f"queue depth {pending} ({per_host:.1f}/host over "
        f"{live} live host(s))"
        + (f", +{growth:.0f} in {cfg.spike_window_s:.0f}s"
           if growth is not None else ""),
        value=per_host, threshold=cfg.up_pending_per_host)]


def _spike(obs: dict, cfg: AlertConfig, path: str, threshold: int,
           label: str) -> List[dict]:
    out: List[dict] = []
    now = obs["time"]
    for host, samples in sorted(obs["history"].items()):
        d = history.window_delta(samples, path, now, cfg.spike_window_s)
        if d is not None and d[0] >= threshold:
            out.append(_finding(
                host, f"{int(d[0])} {label} in the last {d[1]:.0f}s",
                value=d[0], threshold=threshold))
    return out


def _rule_reclaim_spike(obs: dict, cfg: AlertConfig) -> List[dict]:
    return _spike(obs, cfg, "fleet.reclaimed", cfg.reclaim_spike,
                  "lease reclaim(s)")


def _rule_quarantine_spike(obs: dict, cfg: AlertConfig) -> List[dict]:
    return _spike(obs, cfg, "fleet.queue.quarantined",
                  cfg.quarantine_spike, "queue quarantine(s)")


def _rule_nonfinite(obs: dict, cfg: AlertConfig) -> List[dict]:
    """Any windowed increase of non-finite feature values pages: the
    health gate quarantines them instead of writing (telemetry/
    health.py), so an increase means the model itself is emitting
    NaN/Inf — never acceptable at any rate."""
    return [replace_summary(f, f"non-finite feature values: {f['summary']}")
            for f in _spike(obs, cfg, "nonfinite_total", 1,
                            "new NaN/Inf value(s)")]


def replace_summary(finding: dict, summary: str) -> dict:
    finding = dict(finding)
    finding["summary"] = summary
    return finding


def _collapse(obs: dict, cfg: AlertConfig, hits_path: str,
              misses_path: str, min_lookups: int,
              label: str) -> List[dict]:
    """Hit-rate collapse: the windowed rate fell below
    ``collapse_factor`` x the cumulative rate the run had earned — a
    warm store going cold mid-run (rotting entries, a fingerprint
    bump, an eviction storm), not a store that was never warm."""
    out: List[dict] = []
    now = obs["time"]
    for host, samples in sorted(obs["history"].items()):
        hits = history.window_delta(samples, hits_path, now,
                                    cfg.spike_window_s)
        misses = history.window_delta(samples, misses_path, now,
                                      cfg.spike_window_s)
        if hits is None or misses is None:
            continue
        lookups = hits[0] + misses[0]
        if lookups < min_lookups:
            continue
        rate = hits[0] / lookups
        total_h = history.latest(samples, hits_path) or 0
        total_m = history.latest(samples, misses_path) or 0
        total = total_h + total_m
        baseline = total_h / total if total else 0.0
        if baseline < cfg.min_baseline_rate:
            continue  # never warm: nothing collapsed
        if rate < cfg.collapse_factor * baseline:
            out.append(_finding(
                host,
                f"{label} hit rate collapsed to {rate:.0%} over the "
                f"last {int(lookups)} lookup(s) (run baseline "
                f"{baseline:.0%})",
                value=rate, threshold=cfg.collapse_factor * baseline))
    return out


def _rule_cache_collapse(obs: dict, cfg: AlertConfig) -> List[dict]:
    return _collapse(obs, cfg, "cache.hits", "cache.misses",
                     cfg.cache_min_lookups, "feature-cache")


def _rule_compile_cache_collapse(obs: dict, cfg: AlertConfig
                                 ) -> List[dict]:
    return _collapse(obs, cfg, "compile_cache.hits",
                     "compile_cache.misses", cfg.compile_min_lookups,
                     "compile-cache")


def _rule_mfu_regression(obs: dict, cfg: AlertConfig) -> List[dict]:
    """A family's MFU falling below ``mfu_regression_frac`` x the median
    of ITS OWN retained history on the same host — the continuous
    version of the roofline verdict (telemetry/roofline.py): the chip
    didn't change, so a sustained drop means the feed did."""
    out: List[dict] = []
    for host, samples in sorted(obs["history"].items()):
        by_fam: Dict[str, List[float]] = {}
        for s in samples:
            for fam, mfu in (s.get("mfu") or {}).items():
                if mfu is not None:
                    by_fam.setdefault(str(fam), []).append(float(mfu))
        for fam, series in sorted(by_fam.items()):
            if len(series) < cfg.mfu_min_history + 1:
                continue
            current, prior = series[-1], sorted(series[:-1])
            median = prior[len(prior) // 2]
            if median > 0 and current < cfg.mfu_regression_frac * median:
                out.append(_finding(
                    f"{host}/{fam}",
                    f"MFU {100 * current:.1f}% is below "
                    f"{cfg.mfu_regression_frac:.0%} of this host's own "
                    f"median {100 * median:.1f}% "
                    f"({len(prior)} retained samples)",
                    value=current,
                    threshold=cfg.mfu_regression_frac * median))
    return out


def _rule_failure_spike(obs: dict, cfg: AlertConfig) -> List[dict]:
    """Windowed terminal failures (error + quarantined videos) — the
    catch-all that turns a chaos-injected fault or a poison input burst
    into a visible incident with its journal tail already bundled."""
    out: List[dict] = []
    now = obs["time"]
    for host, samples in sorted(obs["history"].items()):
        total = 0.0
        span = 0.0
        seen = False
        for path in ("videos.error", "videos.quarantined"):
            d = history.window_delta(samples, path, now,
                                     cfg.spike_window_s)
            if d is not None:
                seen = True
                total += d[0]
                span = max(span, d[1])
        if seen and total >= cfg.failure_spike:
            out.append(_finding(
                host,
                f"{int(total)} terminal failure(s) in the last "
                f"{span:.0f}s (journal tail in the incident bundle)",
                value=total, threshold=cfg.failure_spike))
    return out


def _rule_disk_pressure(obs: dict, cfg: AlertConfig) -> List[dict]:
    """Burn-rate alarm on the storage accounting (the heartbeat's ``gc``
    section, retained by history): fires at
    ``disk_pressure_frac`` of the quota level, or earlier when the
    windowed growth rate projects the quota full inside
    ``disk_horizon_s`` — a full disk is a fleet-wide FATAL (ENOSPC,
    utils/faults.py), so the page has to land while garbage collection
    can still win the race."""
    out: List[dict] = []
    now = obs["time"]
    for host, samples in sorted(obs["history"].items()):
        used = history.latest(samples, "gc.used_bytes")
        quota = history.latest(samples, "gc.quota_bytes")
        if not used or not quota:
            continue  # accounting off, or no quota configured
        used_f, quota_f = float(used), float(quota)
        if used_f >= cfg.disk_pressure_frac * quota_f:
            out.append(_finding(
                host,
                f"disk usage {used_f / 1e9:.2f}GB at "
                f"{100.0 * used_f / quota_f:.0f}% of the "
                f"{quota_f / 1e9:.2f}GB quota",
                value=used_f / quota_f,
                threshold=cfg.disk_pressure_frac))
            continue
        grow = history.window_delta(samples, "gc.used_bytes", now,
                                    cfg.spike_window_s,
                                    allow_negative=True)
        if grow is None or grow[0] <= 0 or grow[1] <= 0:
            continue  # flat or shrinking (GC winning): no projection
        rate = grow[0] / grow[1]  # bytes/s
        ttf = (quota_f - used_f) / rate
        if ttf < cfg.disk_horizon_s:
            out.append(_finding(
                host,
                f"disk filling at {rate / 1e6:.2f}MB/s — quota "
                f"{quota_f / 1e9:.2f}GB projected full in "
                f"{ttf:.0f}s (< {cfg.disk_horizon_s:.0f}s horizon)",
                value=ttf, threshold=cfg.disk_horizon_s))
    return out


def _rule_parity_drift(obs: dict, cfg: AlertConfig) -> List[dict]:
    """Per-seam numerics drift off the certify verdict artifacts
    (telemetry/parity.py ``_parity_verdict.json``, collected by
    ``observe_root``): one finding per out-of-band seam, scoped
    ``{host}/family={f}/seam={s}`` so the page names WHERE the numerics
    went, not just that they did. The episode clears when a re-certify
    PASS overwrites the verdict — the artifact is the state."""
    from . import parity
    out: List[dict] = []
    for doc in obs.get("parity") or []:
        fam = str(doc.get("family") or "?")
        host = str(doc.get("host") or "?")
        seams = doc.get("seams") or {}
        for seam in parity.SEAMS:
            m = seams.get(seam)
            if not isinstance(m, dict) or m.get("ok", True):
                continue
            note = m.get("note")
            out.append(_finding(
                f"{host}/family={fam}/seam={seam}",
                (f"parity drift at the {seam} seam"
                 + (f" ({note})" if note else
                    f": max_abs={m.get('max_abs')} vs band "
                    f"{m.get('tol_max_abs')}, cos={m.get('cos')} vs floor "
                    f"{m.get('tol_cos')}")
                 + (f" — flip {doc.get('flip')}" if doc.get("flip")
                    else "")),
                value=m.get("max_abs"), threshold=m.get("tol_max_abs")))
    return out


BUILTIN_RULES: Tuple[AlertRule, ...] = (
    AlertRule("slo_burn_rate", "page",
              "multi-window serve SLO burn over the error budget",
              _rule_slo_burn),
    AlertRule("host_stalled", "page",
              "heartbeat silent past the stall window (while holding "
              "leases, where claim tracking exists)",
              _rule_host_stalled),
    AlertRule("nonfinite_features", "page",
              "NaN/Inf feature values increasing",
              _rule_nonfinite),
    AlertRule("quarantine_spike", "page",
              "fleet-queue items quarantined as pathological",
              _rule_quarantine_spike),
    AlertRule("queue_depth_growth", "ticket",
              "backlog at/past the per-host trip point and not draining",
              _rule_queue_growth),
    AlertRule("reclaim_spike", "ticket",
              "lease reclaims spiking (hosts dying mid-work)",
              _rule_reclaim_spike),
    AlertRule("failure_spike", "ticket",
              "terminal video failures in the window",
              _rule_failure_spike),
    AlertRule("cache_hit_collapse", "ticket",
              "feature-cache hit rate collapsed vs the run baseline",
              _rule_cache_collapse),
    AlertRule("compile_cache_collapse", "ticket",
              "compile-cache hit rate collapsed vs the run baseline",
              _rule_compile_cache_collapse),
    AlertRule("mfu_regression", "ticket",
              "family MFU below its own retained history",
              _rule_mfu_regression),
    AlertRule("disk_pressure", "page",
              "storage usage at the quota level, or growth projecting "
              "it full within the horizon",
              _rule_disk_pressure),
    AlertRule("parity_drift", "page",
              "certified per-seam numerics error outside its tolerance "
              "band",
              _rule_parity_drift),
)


# -- observation --------------------------------------------------------------

def _safe_scope(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(s))


def _claims_by_host(root: str) -> Tuple[Dict[str, int], bool]:
    """Per-host outstanding claim counts off the ground-truth dirs: the
    fleet queue's ``_queue/claimed/{host}/`` and the serve spool's
    ``claimed/{host}/``. Returns ``({safe_host: count}, tracked)`` —
    ``tracked`` False when neither structure exists (plain batch run)."""
    counts: Dict[str, int] = {}
    tracked = False
    for claimed in (os.path.join(str(root), "_queue", "claimed"),
                    os.path.join(str(root), "claimed")):
        if not os.path.isdir(claimed):
            continue
        tracked = True
        try:
            hosts = os.listdir(claimed)
        except OSError:
            continue
        for h in hosts:
            d = os.path.join(claimed, h)
            if not os.path.isdir(d):
                continue
            try:
                n = sum(1 for x in os.listdir(d) if x.endswith(".json"))
            except OSError:
                n = 0
            counts[h] = counts.get(h, 0) + n
    return counts, tracked


def observe_root(root: str, now: Optional[float] = None) -> dict:
    """Everything the rules read, gathered from artifacts alone (no
    live process — works on a dead fleet): heartbeat states, queue
    counts, per-host claim ground truth, retained history. Deliberately
    lighter than ``fleet_report.aggregate`` (no span/roofline sweeps):
    this runs on every heartbeat tick of every alerting host."""
    from ..fleet_report import _queue_counts, collect_heartbeats
    from . import parity
    now = time.time() if now is None else float(now)
    entries = collect_heartbeats(str(root), now=now)
    claims, tracked = _claims_by_host(root)
    return {
        "root": str(root),
        "time": now,
        "hosts": entries,
        "n_live": sum(1 for e in entries
                      if e.get("hb") is not None
                      and not e.get("prior_run")
                      and e["state"] == "live"),
        "queue": _queue_counts(str(root), entries),
        "claims": claims,
        "claims_tracked": tracked,
        "history": history.read_history(str(root)),
        # certify verdict artifacts (telemetry/parity.py): the
        # parity_drift rule reads per-seam ok flags off these
        "parity": parity.collect_verdicts(str(root)),
    }


# -- journal state ------------------------------------------------------------

def load_states(root: str) -> Dict[Tuple[str, str], dict]:
    """Open/closed episodes reconstructed from ``_alerts.jsonl``: the
    last record per (rule, scope) wins — the journal IS the state, so
    any evaluator (in-process hook, cron one-shot, watcher) continues
    where the previous one stopped."""
    out: Dict[Tuple[str, str], dict] = {}
    for rec in jsonl.read_jsonl(os.path.join(str(root), ALERTS_FILENAME)):
        if rec.get("schema") != SCHEMA_VERSION:
            continue
        out[(str(rec.get("rule")), str(rec.get("scope")))] = rec
    return out


def current_alerts(root: str, started_time: Optional[float] = None
                   ) -> List[dict]:
    """Every episode currently pending or firing — the render/gate/prom
    input. ``started_time`` (the manifest's) excludes records a PRIOR
    run of the same directory left open: an alert whose last transition
    predates this run's start is that run's business, not ours."""
    out = []
    for rec in load_states(str(root)).values():
        if rec.get("state") not in ("pending", "firing"):
            continue
        if started_time is not None and \
                float(rec.get("time", 0)) < float(started_time):
            continue
        out.append(rec)
    return sorted(out, key=lambda r: (r.get("state") != "firing",
                                      str(r.get("rule")),
                                      str(r.get("scope"))))


# -- the engine ---------------------------------------------------------------

class AlertEngine:
    """Evaluate rules against a root, append transitions, capture
    incident bundles. Stateless across processes by design (the journal
    reconstructs episodes); ``clear_for_s`` dwell is the only in-memory
    refinement, used by long-running engines."""

    def __init__(self, root: str, *, rules=BUILTIN_RULES,
                 cfg: Optional[AlertConfig] = None,
                 run_id: Optional[str] = None,
                 capture_incidents: bool = True,
                 clock=time.time) -> None:
        self.root = str(root)
        self.rules = tuple(rules)
        self.cfg = cfg or AlertConfig()
        self.run_id = run_id
        self.capture_incidents = capture_incidents
        self.clock = clock
        self.alerts_path = os.path.join(self.root, ALERTS_FILENAME)
        self._ok_since: Dict[Tuple[str, str], float] = {}
        self._last_summary: Dict[str, object] = {
            "firing": 0, "pending": 0, "names": []}
        self._recorder = None
        self.eval_errors = 0

    # -- one evaluation pass ------------------------------------------------
    def evaluate(self, obs: Optional[dict] = None,
                 now: Optional[float] = None) -> List[dict]:
        """Run every rule once; returns the records emitted (state
        transitions only — a steadily-firing alert emits nothing)."""
        now = self.clock() if now is None else float(now)
        if obs is None:
            obs = observe_root(self.root, now=now)
        states = load_states(self.root)
        emitted: List[dict] = []
        found: Dict[Tuple[str, str], Tuple[AlertRule, dict]] = {}
        for rule in self.rules:
            try:
                findings = rule.evaluate(obs, self.cfg)
            except Exception as e:
                self.eval_errors += 1
                print(f"alerts: rule {rule.name} failed: "
                      f"{type(e).__name__}: {e}")
                continue
            for f in findings:
                found[(rule.name, f["scope"])] = (rule, f)

        for key, (rule, f) in sorted(found.items()):
            st = states.get(key)
            open_ep = st is not None and st.get("state") in ("pending",
                                                             "firing")
            self._ok_since.pop(key, None)
            if not open_ep:
                alert_id = self._mint(rule.name, f["scope"])
                if rule.for_s > 0:
                    emitted.append(self._emit(
                        rule, f, "pending", alert_id, since=now, now=now))
                else:
                    emitted.append(self._fire(rule, f, alert_id,
                                              since=now, now=now, obs=obs))
            elif st.get("state") == "pending":
                since = float(st.get("since", now))
                if now - since >= rule.for_s:
                    emitted.append(self._fire(
                        rule, f, str(st.get("alert_id")), since=since,
                        now=now, obs=obs))
                # else: still pending — dedup, no record

        rules_by_name = {r.name: r for r in self.rules}
        for key, st in sorted(states.items()):
            if key in found or st.get("state") not in ("pending", "firing"):
                continue
            rule = rules_by_name.get(key[0])
            clear_for = rule.clear_for_s if rule is not None else 0.0
            if st.get("state") == "firing" and clear_for > 0:
                ok0 = self._ok_since.setdefault(key, now)
                if now - ok0 < clear_for:
                    continue  # condition clear but not yet for long enough
            self._ok_since.pop(key, None)
            rec = dict(st)
            rec.update(state="resolved", time=round(now, 3),
                       run_id=self.run_id)
            rec = {k: rec.get(k) for k in ALERT_FIELDS}
            rec["schema"] = SCHEMA_VERSION
            jsonl.append_jsonl(self.alerts_path, rec)
            emitted.append(rec)

        active = current_alerts(self.root)
        self._last_summary = {
            "firing": sum(1 for a in active if a["state"] == "firing"),
            "pending": sum(1 for a in active if a["state"] == "pending"),
            "names": [f"{a['rule']}:{a['scope']}" for a in active[:8]],
        }
        return emitted

    def _mint(self, rule: str, scope: str) -> str:
        return (f"{_safe_scope(rule)}-{_safe_scope(scope)}-"
                f"{uuid.uuid4().hex[:8]}")

    def _record(self, rule: AlertRule, f: dict, state: str, alert_id: str,
                since: float, now: float,
                incident: Optional[str] = None) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "alert_id": alert_id,
            "rule": rule.name,
            "severity": rule.severity,
            "state": state,
            "scope": f["scope"],
            "summary": f["summary"],
            "value": f.get("value"),
            "threshold": f.get("threshold"),
            "since": round(since, 3),
            "time": round(now, 3),
            "run_id": self.run_id,
            "incident": incident,
        }

    def _emit(self, rule: AlertRule, f: dict, state: str, alert_id: str,
              since: float, now: float,
              incident: Optional[str] = None) -> dict:
        rec = self._record(rule, f, state, alert_id, since, now, incident)
        jsonl.append_jsonl(self.alerts_path, rec)
        return rec

    def _fire(self, rule: AlertRule, f: dict, alert_id: str,
              since: float, now: float, obs: dict) -> dict:
        incident = None
        if self.capture_incidents:
            rec = self._record(rule, f, "firing", alert_id, since, now)
            incident = capture_incident(self.root, rec, now=now)
        return self._emit(rule, f, "firing", alert_id, since, now,
                          incident=incident)

    # -- recorder hook ------------------------------------------------------
    def attach(self, recorder) -> "AlertEngine":
        """Evaluate on every heartbeat tick and publish the episode
        summary as the heartbeat ``alerts`` section (one tick behind the
        evaluation it summarizes — sections render before hooks run)."""
        self._recorder = recorder
        recorder.tick_hooks.append(self._on_tick)
        recorder.extra_sections["alerts"] = self.heartbeat_section
        return self

    def _on_tick(self, hb: dict) -> None:
        try:
            self.evaluate()
        except Exception as e:
            # alerting must never become the outage: count and carry on
            self.eval_errors += 1
            if self.eval_errors <= 1:
                print(f"alerts: evaluation failed: "
                      f"{type(e).__name__}: {e}")

    def heartbeat_section(self) -> dict:
        return dict(self._last_summary, eval_errors=self.eval_errors)


# -- the flight recorder ------------------------------------------------------

#: trace events captured around an incident (seconds before firing)
INCIDENT_TRACE_WINDOW_S = 300.0
#: jsonl tail length per captured journal
INCIDENT_TAIL_LINES = 200

#: journals tailed into every bundle
_TAIL_NAMES = ("_failures.jsonl", "_telemetry.jsonl", "_health.jsonl",
               ALERTS_FILENAME)


def _sha256(path: str) -> Tuple[int, str]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
            n += len(chunk)
    return n, h.hexdigest()


def _bundle_name(root: str, p: Path) -> str:
    rel = os.path.relpath(str(p), str(root))
    return _safe_scope(rel)


def capture_incident(root: str, record: dict,
                     now: Optional[float] = None,
                     tail_lines: int = INCIDENT_TAIL_LINES
                     ) -> Optional[str]:
    """Write the black box for one firing alert:
    ``{root}/_incidents/{alert_id}/`` holding the current heartbeats,
    the tail of every journal (failures/spans/health/alerts/history),
    a stitched cross-host trace window, the ``_queue`` counts and the
    roofline roll-up (inside a ``roofline=true`` run whose artifact is not
    written yet, that run's live summary) — plus ``manifest.json`` listing
    every captured
    artifact with its size and sha256 (written LAST: a manifest's
    presence marks the bundle complete). Returns the bundle path
    relative to ``root``, or None — capture failure degrades to an
    alert without a bundle, never to a failed evaluation."""
    try:
        now = time.time() if now is None else float(now)
        root = str(root)
        alert_id = _safe_scope(record.get("alert_id") or "alert")
        rel_bundle = os.path.join(INCIDENTS_DIRNAME, alert_id)
        bundle = os.path.join(root, rel_bundle)
        os.makedirs(bundle, exist_ok=True)
        artifacts: List[dict] = []
        root_p = Path(root)

        def _add(rel: str) -> None:
            full = os.path.join(bundle, rel)
            size, sha = _sha256(full)
            artifacts.append({"path": rel, "bytes": size, "sha256": sha})

        def _write(rel: str, text: str) -> None:
            full = os.path.join(bundle, rel)
            os.makedirs(os.path.dirname(full) or bundle, exist_ok=True)
            # vft-lint: disable=VFT004 — bundle integrity is manifest-hash-based: manifest.json is written LAST over the recorded sha256s, so a torn artifact fails verify_incident instead of being trusted
            with open(full, "w", encoding="utf-8") as f:
                f.write(text)
            _add(rel)

        _write("alert.json", json.dumps(record, indent=2, sort_keys=True))

        # the heartbeats as they were at firing time — exactly the files
        # the next tick would have overwritten. Captured names are
        # prefixed so no collector glob (HEARTBEAT_GLOB etc.) can ever
        # re-ingest a frozen snapshot as a live artifact — a bundle
        # must be inert evidence, not a ghost host.
        from .heartbeat import HEARTBEAT_GLOB
        for p in sorted(root_p.rglob(HEARTBEAT_GLOB)):
            if INCIDENTS_DIRNAME in p.parts:
                continue
            try:
                _write(os.path.join("heartbeats",
                                    "hb-" + _bundle_name(root, p)),
                       p.read_text(encoding="utf-8", errors="replace"))
            except OSError:
                continue

        # journal tails: enough context to see the minutes before the
        # incident without copying gigabytes of history
        names = list(_TAIL_NAMES)
        for p in sorted(root_p.rglob(history.HISTORY_GLOB)):
            if INCIDENTS_DIRNAME not in p.parts:
                names.append(os.path.relpath(str(p), root))
        seen_tails = set()
        for name in names:
            for p in sorted(root_p.rglob(os.path.basename(name))):
                if INCIDENTS_DIRNAME in p.parts or str(p) in seen_tails:
                    continue
                seen_tails.add(str(p))
                try:
                    lines = p.read_text(encoding="utf-8",
                                        errors="replace").splitlines(True)
                except OSError:
                    continue
                # ".tail" suffix: span/health/history collectors glob on
                # *.jsonl and must never double-count bundle copies
                _write(os.path.join("tails",
                                    _bundle_name(root, p) + ".tail"),
                       "".join(lines[-tail_lines:]))

        # stitched cross-host trace, clipped to the incident window
        try:
            from ..fleet_report import find_trace_files, stitch_traces
            docs = []
            for p in find_trace_files(root):
                if INCIDENTS_DIRNAME in p.parts:
                    continue
                try:
                    with open(p, encoding="utf-8") as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                if isinstance(doc.get("traceEvents"), list):
                    docs.append((_bundle_name(root, p), doc))
            if docs:
                merged = stitch_traces(docs)
                anchor = (merged.get("otherData") or {}).get("anchor_unix")
                if isinstance(anchor, (int, float)):
                    lo = (now - INCIDENT_TRACE_WINDOW_S - anchor) * 1e6
                    merged["traceEvents"] = [
                        ev for ev in merged["traceEvents"]
                        if not isinstance(ev.get("ts"), (int, float))
                        or ev["ts"] >= lo]
                    merged["otherData"]["incident_window_s"] = \
                        INCIDENT_TRACE_WINDOW_S
                _write("trace_window.json", json.dumps(merged))
        except Exception:
            pass

        # queue ground truth + per-host claims at firing time
        claims, tracked = _claims_by_host(root)
        if tracked or os.path.isdir(os.path.join(root, "_queue")):
            from ..fleet_report import _queue_counts
            _write("queue.json", json.dumps(
                {"counts": _queue_counts(root, []),
                 "claims_by_host": claims}, indent=2, sort_keys=True))

        # roofline roll-up, when any host ran with roofline=true; a host
        # writes its _roofline.json at exit, so an alert that fires inside
        # the run it observes takes that run's live summary instead, when
        # this process's roofline observer writes under the root
        try:
            from . import roofline
            rf = roofline.aggregate_rooflines(root)
            obs = roofline.active()
            if not rf and obs is not None and os.path.abspath(
                    obs.path).startswith(os.path.abspath(root) + os.sep):
                rf = roofline.snapshot()
            if rf:
                _write("roofline.json", json.dumps(rf, indent=2,
                                                   sort_keys=True))
        except Exception:
            pass

        jsonl.write_json_atomic(os.path.join(bundle, "manifest.json"), {
            "schema": INCIDENT_SCHEMA,
            "alert_id": record.get("alert_id"),
            "rule": record.get("rule"),
            "scope": record.get("scope"),
            "time": round(now, 3),
            "root": root,
            "artifacts": sorted(artifacts, key=lambda a: a["path"]),
        })
        return rel_bundle
    except Exception as e:
        print(f"alerts: incident capture failed: {type(e).__name__}: {e}")
        return None


def verify_incident(bundle: str) -> List[str]:
    """Re-hash every artifact the manifest lists; returns violations
    (missing manifest / missing file / size or sha mismatch). The
    auditor-style completeness check tests and the CI gate share."""
    errs: List[str] = []
    man_path = os.path.join(str(bundle), "manifest.json")
    try:
        with open(man_path, encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable manifest {man_path}: {type(e).__name__}: {e}"]
    if man.get("schema") != INCIDENT_SCHEMA:
        errs.append(f"manifest schema {man.get('schema')!r} != "
                    f"{INCIDENT_SCHEMA!r}")
    arts = man.get("artifacts") or []
    if not arts:
        errs.append("manifest lists no artifacts")
    for a in arts:
        full = os.path.join(str(bundle), str(a.get("path")))
        if not os.path.isfile(full):
            errs.append(f"missing artifact {a.get('path')}")
            continue
        size, sha = _sha256(full)
        if size != a.get("bytes") or sha != a.get("sha256"):
            errs.append(f"artifact {a.get('path')}: bytes/sha mismatch "
                        "vs manifest")
    return errs


# -- rendering / prom ---------------------------------------------------------

def render_alerts(active: List[dict]) -> List[str]:
    """The ``== alerts ==`` block that ``telemetry/report.py`` and
    ``fleet_report.py`` share."""
    if not active:
        return []
    firing = sum(1 for a in active if a["state"] == "firing")
    pending = len(active) - firing
    lines = [f"== alerts ==  {firing} firing / {pending} pending"]
    for a in active:
        line = (f"  [{a['severity'].upper():<6}] {a['state'].upper():<7} "
                f"{a['rule']}({a['scope']}): {a['summary']}")
        if a.get("incident"):
            line += f"  [bundle: {a['incident']}]"
        lines.append(line)
    return lines


def alerts_prom_series(active: List[dict]) -> List[dict]:
    """Prometheus ``ALERTS``-style gauges (the exact shape an
    Alertmanager-fed rule evaluator exports): one ``ALERTS{alertname,
    severity, alertstate, scope} 1`` per live episode, for the
    telemetry/metrics.py dump format."""
    return [{"name": "ALERTS", "kind": "gauge",
             "labels": {"alertname": str(a["rule"]),
                        "alertstate": str(a["state"]),
                        "severity": str(a["severity"]),
                        "scope": str(a["scope"])},
             "value": 1.0} for a in active]


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    """``python -m video_features_tpu_torch.telemetry.alerts ROOT``:
    evaluate the rules against a shared root, once (for cron or CI) or
    continuously beside ``python -m video_features_tpu_torch.fleet_report
    ROOT --watch``."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description="evaluate alert rules over a fleet root's artifacts "
                    "and maintain _alerts.jsonl + incident bundles")
    ap.add_argument("root", help="the fleet's shared output root (or a "
                                 "serving spool dir)")
    ap.add_argument("--watch", action="store_true",
                    help="evaluate continuously until interrupted")
    ap.add_argument("--every", type=float, default=5.0,
                    help="--watch evaluation period in seconds (default 5)")
    ap.add_argument("--iterations", type=int, default=0,
                    help="--watch passes before exiting (0 = forever)")
    ap.add_argument("--window", type=float, default=None,
                    help="short/spike window override in seconds")
    ap.add_argument("--long-window", type=float, default=None,
                    help="long burn window override in seconds")
    ap.add_argument("--slo-target", type=float, default=None,
                    help="SLO attainment target %% (default 95)")
    ap.add_argument("--no-incidents", action="store_true",
                    help="evaluate and journal only; skip bundle capture")
    ap.add_argument("--prom", metavar="FILE", default=None,
                    help="write ALERTS-style gauges as a Prometheus "
                         "textfile")
    ap.add_argument("--fail-on-firing", action="store_true",
                    help="exit 1 while any alert is firing (the cron/CI "
                         "gate)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"error: {args.root} is not a directory", file=sys.stderr)
        return 2
    overrides = {}
    if args.window is not None:
        overrides.update(short_window_s=args.window,
                         spike_window_s=args.window)
    if args.long_window is not None:
        overrides["long_window_s"] = args.long_window
    if args.slo_target is not None:
        overrides["slo_target_pct"] = args.slo_target
    cfg = replace(AlertConfig(), **overrides) if overrides \
        else AlertConfig()
    engine = AlertEngine(args.root, cfg=cfg,
                         capture_incidents=not args.no_incidents)
    passes = 0
    active: List[dict] = []
    while True:
        emitted = engine.evaluate()
        active = current_alerts(args.root)
        for rec in emitted:
            print(f"-> {rec['state'].upper():<8} [{rec['severity']}] "
                  f"{rec['rule']}({rec['scope']}): {rec['summary']}"
                  + (f"  [bundle: {rec['incident']}]"
                     if rec.get("incident") else ""))
        lines = render_alerts(active)
        print("\n".join(lines) if lines
              else f"alerts: none active under {args.root}")
        passes += 1
        if not args.watch or (args.iterations
                              and passes >= args.iterations):
            break
        try:
            time.sleep(max(0.05, args.every))
        except KeyboardInterrupt:
            break
    if args.prom:
        from .metrics import prometheus_text
        from ..utils.sinks import _write_bytes_atomic
        dump = {"series": alerts_prom_series(active)}
        # textfile-collector convention: rename into place so a
        # mid-write scrape never parses half an ALERTS series
        _write_bytes_atomic(args.prom, prometheus_text(dump).encode("utf-8"))
        print(f"prometheus textfile: {args.prom} "
              f"({len(dump['series'])} series)")
    if args.fail_on_firing and any(a["state"] == "firing"
                                   for a in active):
        firing = [a for a in active if a["state"] == "firing"]
        print("fail-on-firing: "
              + ", ".join(f"{a['rule']}({a['scope']})" for a in firing),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
