"""One view of the whole fleet from its artifacts (port of
``video_features_tpu/fleet_report.py``).

The per-run report (``telemetry/report.py``) reads one output dir. A fleet
of hosts sharing one output root has no single place to ask whether every
host is alive, which one is the straggler, what the cache does and whether
serving meets its SLO. This module is that place: pointed at the shared
root, it merges every host's heartbeats, the queue counts, the cache hit
rates, per-family throughput (from the span records), the roofline roll-up,
the certify verdicts, serving SLO attainment and the active alerts into
one report, and flags the host the rest of the fleet idles behind.

    python -m video_features_tpu_torch.fleet_report ROOT             # once
    python -m video_features_tpu_torch.fleet_report ROOT --watch     # 2 s refresh
    python -m video_features_tpu_torch.fleet_report ROOT --prom FILE # textfile
    python -m video_features_tpu_torch.fleet_report ROOT --stitch    # one trace
    python -m video_features_tpu_torch.fleet_report ROOT --request ID

Everything comes from artifacts (heartbeats, ``_run.json``,
``_telemetry.jsonl``, ``_health.jsonl``, ``_trace*.json``, ``_alerts.jsonl``,
the ``_queue`` and spool dirs), so it works on a dead fleet too. The formats
are the JAX package's, so one root may hold hosts of both packages.

**Stitching** (``--stitch``): every host's trace under the root merges into
one Chrome-trace file with one process lane per host, aligned on each
trace's wall-clock anchor (``otherData.start_unix``, ``telemetry/trace.py``):
event time becomes ``anchor + ts``, rebased to the earliest anchor. A trace
without an anchor stays at offset 0 and is listed in
``otherData.unanchored``.

**Request lookup** (``--request``): every span record, health digest,
failure-journal entry, trace span, spool file and queue claim that carries
one request id (``telemetry/context.py``), wherever it ran.

The capacity planner, the serving, tenant, queue, compile-cache and storage
sections read what the JAX package's planes write; the port writes them
once it runs those planes (ROADMAP.md Queue 1 #8).
"""
from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .telemetry.heartbeat import (HEARTBEAT_GLOB, STALL_INTERVALS,
                                  matches_run)
from .telemetry.jsonl import read_jsonl
from .telemetry.metrics import prometheus_text
from .telemetry.trace import TRACE_FILENAME, TRACE_OUTPUT_NAMES

SPANS_FILENAME = "_telemetry.jsonl"
MANIFEST_FILENAME = "_run.json"
HEALTH_FILENAME = "_health.jsonl"
FAILURES_FILENAME = "_failures.jsonl"

#: stitched-trace format tag (otherData.schema)
STITCH_SCHEMA = "vft.trace_fleet/1"

#: pid base for stitched host lanes: each host's events are remapped to
#: a distinct pid so Perfetto renders one process group per host
STITCH_PID_BASE = 1000

#: flight-recorder bundles (telemetry/alerts.py) hold frozen COPIES of
#: heartbeats/journals/traces; every artifact collector below must skip
#: this subtree or captured snapshots resurrect as ghost hosts
INCIDENTS_DIRNAME = "_incidents"


def _in_incident(p: Path) -> bool:
    return INCIDENTS_DIRNAME in p.parts


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def _fmt_age(seconds: float) -> str:
    if seconds < 90:
        return f"{seconds:.0f}s"
    if seconds < 5400:
        return f"{seconds / 60:.1f}m"
    return f"{seconds / 3600:.1f}h"


def fleet_stragglers(hbs: List[dict], now: float) -> set:
    """host_ids binding the fleet: a host still holding active fleet
    claims while the shared queue's pending is empty AND at least one
    other live fleet host sits idle — everyone else is waiting on it
    (the per-host ``fleet.idle_wait`` trace spans are the same signal in
    time). Shared by telemetry/report.py and the fleet aggregator."""
    live = []
    for hb in hbs:
        fl = hb.get("fleet")
        if not isinstance(fl, dict) or hb.get("final"):
            continue
        interval = float(hb.get("interval_s", 30.0) or 30.0)
        if now - float(hb.get("time", 0)) > STALL_INTERVALS * interval:
            continue
        live.append((str(hb.get("host_id")), fl))
    if len(live) < 2:
        return set()
    idle = [h for h, fl in live if not fl.get("active_claims")]
    if not idle:
        return set()
    return {h for h, fl in live
            if fl.get("active_claims")
            and not (fl.get("queue") or {}).get("pending", 0)}


# -- collection ---------------------------------------------------------------

def collect_heartbeats(root: str, now: Optional[float] = None) -> List[dict]:
    """Every heartbeat under ``root`` (recursively — fleet workers home
    theirs at the out_root, multi-family runs at the common root, serve
    at the spool), classified against its own directory's manifest:

    ``{"path", "dir", "hb", "state", "age_s", "prior_run"}`` with state
    one of ``live`` / ``STALLED`` / ``FINISHED`` / ``unreadable``.
    Prior-run files (a reused output dir; heartbeat demonstrably from an
    older run than the sibling manifest) are flagged, not dropped — the
    renderer shows them as ignored, the aggregates skip them."""
    now = time.time() if now is None else now
    out: List[dict] = []
    seen: set = set()
    root_p = Path(root)
    paths = [p for p in sorted(root_p.rglob(HEARTBEAT_GLOB))
             if not _in_incident(p)]
    # rglob misses nothing below, but the root itself may BE a file list
    for p in paths:
        rp = str(p.resolve())
        if rp in seen:
            continue
        seen.add(rp)
        entry: Dict[str, Any] = {"path": str(p), "dir": str(p.parent)}
        hb = _load_json(str(p))
        if hb is None:
            entry.update(hb=None, state="unreadable", age_s=None,
                         prior_run=False)
            out.append(entry)
            continue
        man = _load_json(os.path.join(str(p.parent), MANIFEST_FILENAME))
        prior = man is not None and not matches_run(
            hb, man.get("run_id"), man.get("started_time"))
        age = max(0.0, now - float(hb.get("time", now) or now))
        interval = float(hb.get("interval_s", 30.0) or 30.0)
        if hb.get("final"):
            state = "FINISHED"
        elif age > STALL_INTERVALS * interval:
            state = "STALLED"
        else:
            state = "live"
        entry.update(hb=hb, state=state, age_s=round(age, 3),
                     prior_run=bool(prior))
        out.append(entry)
    return out


def collect_family_throughput(root: str) -> Dict[str, dict]:
    """Per-family tallies off every ``_telemetry.jsonl`` under the root:
    records, done/error counts, mean seconds per video — the
    whole-fleet per-family throughput no single host's heartbeat can
    see."""
    fams: Dict[str, dict] = {}
    for path in sorted(Path(root).rglob(SPANS_FILENAME)):
        if _in_incident(path):
            continue
        for rec in read_jsonl(path):
            fam = str(rec.get("feature_type") or "?")
            f = fams.setdefault(fam, {"records": 0, "done": 0, "error": 0,
                                      "wall_s": 0.0})
            f["records"] += 1
            st = rec.get("status")
            if st == "done":
                f["done"] += 1
                f["wall_s"] += float(rec.get("wall_s") or 0.0)
            elif st in ("error", "quarantined"):
                f["error"] += 1
    for f in fams.values():
        f["s_per_video"] = (round(f["wall_s"] / f["done"], 3)
                            if f["done"] else None)
        f["wall_s"] = round(f["wall_s"], 3)
    return fams


def _queue_counts(root: str, entries: List[dict]) -> Optional[dict]:
    """Fleet-queue counts: preferred from the ``_queue`` dir itself (the
    ground truth both workers and this tool read), falling back to the
    freshest live heartbeat's ``fleet.queue`` section."""
    qroot = os.path.join(str(root), "_queue")
    if os.path.isdir(qroot):
        counts = {}
        for d in ("pending", "done", "quarantined"):
            try:
                counts[d] = sum(1 for n in os.listdir(
                    os.path.join(qroot, d)) if n.endswith(".json"))
            except OSError:
                counts[d] = 0
        claimed = 0
        try:
            for h in os.listdir(os.path.join(qroot, "claimed")):
                try:
                    claimed += sum(1 for n in os.listdir(
                        os.path.join(qroot, "claimed", h))
                        if n.endswith(".json"))
                except OSError:
                    pass
        except OSError:
            pass
        counts["claimed"] = claimed
        return counts
    best = None
    for e in entries:
        hb = e.get("hb") or {}
        fl = hb.get("fleet")
        if not isinstance(fl, dict) or e.get("prior_run"):
            continue
        if best is None or float(hb.get("time", 0)) > \
                float((best.get("hb") or {}).get("time", 0)):
            best = e
    if best is None:
        return None
    return dict(((best.get("hb") or {}).get("fleet") or {})
                .get("queue") or {})


def _newest_started_time(root: str) -> Optional[float]:
    """The freshest manifest's ``started_time`` under the root — the
    prior-run cutoff for alert gating (an alert whose last transition
    predates every current run is a previous run's business)."""
    best: Optional[float] = None
    for p in sorted(Path(str(root)).rglob(MANIFEST_FILENAME)):
        if _in_incident(p):
            continue
        man = _load_json(str(p))
        st = (man or {}).get("started_time")
        try:
            if st is not None:
                best = float(st) if best is None else max(best, float(st))
        except (TypeError, ValueError):
            continue
    return best


def collect_alerts(root: str) -> List[dict]:
    """Active (pending/firing) alert episodes off ``_alerts.jsonl``,
    prior-run excluded against the newest sibling manifest
    (telemetry/alerts.py owns the journal contract)."""
    try:
        from .telemetry.alerts import current_alerts
        return current_alerts(str(root),
                              started_time=_newest_started_time(root))
    except Exception:
        return []


def collect_scenarios(root: str) -> List[dict]:
    """Every recorded-drill verdict under the root (``_scenario.json``,
    written by the JAX package's load generator): the traffic-scenario
    observatory — rendered as the
    ``== scenarios ==`` section and exported as ``vft_scenario_*``
    gauges. Sorted by artifact time so the freshest drill renders
    last."""
    out: List[dict] = []
    for p in sorted(Path(str(root)).rglob("_scenario.json")):
        if _in_incident(p):
            continue
        doc = _load_json(str(p))
        if doc is not None and \
                str(doc.get("schema", "")).startswith("vft.scenario/"):
            out.append(doc)
    out.sort(key=lambda d: float(d.get("time") or 0.0))
    return out


def aggregate(root: str, now: Optional[float] = None) -> dict:
    """The one-view fleet snapshot: everything the renderer, the prom
    exporter and the tests consume, as plain JSON-safe data."""
    now = time.time() if now is None else now
    entries = collect_heartbeats(root, now=now)
    current = [e for e in entries
               if e.get("hb") is not None and not e["prior_run"]]
    hbs = [e["hb"] for e in current]
    stragglers = fleet_stragglers(hbs, now)

    cache = {"hits": 0, "misses": 0, "bypasses": 0}
    by_family_cache: Dict[str, Dict[str, int]] = {}
    compile_cache = {"hits": 0, "misses": 0, "warm_hosts": 0,
                     "attached_hosts": 0, "dropped": 0}
    cc_entries: set = set()
    slo_hosts: List[dict] = []
    slo_totals = {"requests": 0, "violations": 0}
    # per-tenant roll-up: answered/violated from serving heartbeats, door
    # rejections + sheds from gateway heartbeats, one attainment line per
    # tenant, fleet-wide
    tenant_totals: Dict[str, Dict[str, object]] = {}

    def _tenant(t: str) -> Dict[str, object]:
        return tenant_totals.setdefault(
            str(t), {"requests": 0, "violations": 0, "rejects": 0})
    idle_inputs = {"idle_wait_s_total": 0.0, "uptime_s": 0.0,
                   "fleet_hosts": 0}
    # storage accounting (the heartbeat's gc section): every host samples
    # the SAME
    # shared root, so the fleet view is the freshest host's snapshot,
    # not a sum — summing would multiply the tree by n_hosts
    gc_section: Optional[dict] = None
    gc_time = float("-inf")
    for e in current:
        hb = e["hb"]
        cc = hb.get("compile_cache")
        if isinstance(cc, dict):
            compile_cache["hits"] += int(cc.get("hits") or 0)
            compile_cache["misses"] += int(cc.get("misses") or 0)
            compile_cache["dropped"] += int(cc.get("dropped") or 0)
            if cc.get("entry"):
                compile_cache["attached_hosts"] += 1
                cc_entries.add(str(cc["entry"]))
            if cc.get("warm_at_attach"):
                compile_cache["warm_hosts"] += 1
        fl = hb.get("fleet")
        if isinstance(fl, dict) and e["state"] == "live":
            idle_inputs["idle_wait_s_total"] += \
                float(fl.get("idle_wait_s_total") or 0.0)
            idle_inputs["uptime_s"] += float(hb.get("uptime_s") or 0.0)
            idle_inputs["fleet_hosts"] += 1
        ca = hb.get("cache") or {}
        for k in ("hits", "misses", "bypasses"):
            per = ca.get(k) or {}
            cache[k] += sum(int(v) for v in per.values())
            for fam, v in per.items():
                by_family_cache.setdefault(fam, {}).setdefault(k, 0)
                by_family_cache[fam][k] += int(v)
        serve = hb.get("serve")
        if isinstance(serve, dict):
            slo = serve.get("slo") or {}
            slo_hosts.append({
                "host_id": hb.get("host_id"), "state": serve.get("state"),
                "hb_state": e["state"],
                "pending": serve.get("pending"),
                "inflight": serve.get("inflight"),
                "active_requests": serve.get("active_requests") or [],
                "requests": serve.get("requests") or {}, "slo": slo})
            slo_totals["requests"] += int(slo.get("requests") or 0)
            slo_totals["violations"] += int(slo.get("violations") or 0)
            for t, v in (serve.get("tenants") or {}).items():
                tt = _tenant(t)
                tt["requests"] += int(v.get("requests") or 0)
                tt["violations"] += int(v.get("violations") or 0)
                tt["rejects"] += int(v.get("rejects") or 0)
        gw = hb.get("gateway")
        if isinstance(gw, dict):
            for t, v in (gw.get("tenants") or {}).items():
                tt = _tenant(t)
                tt["rejects"] += (int(v.get("rejected") or 0)
                                  + int(v.get("shed") or 0))
        g_sec = hb.get("gc")
        if isinstance(g_sec, dict):
            try:
                t_hb = float(hb.get("time") or 0.0)
            except (TypeError, ValueError):
                t_hb = 0.0
            if t_hb > gc_time:
                gc_time = t_hb
                gc_section = dict(g_sec)
    for tt in tenant_totals.values():
        n = int(tt["requests"])
        tt["attainment_pct"] = (
            round(100.0 * (n - int(tt["violations"])) / n, 2)
            if n else None)
    consulted = cache["hits"] + cache["misses"]
    cache["hit_rate"] = (round(cache["hits"] / consulted, 4)
                         if consulted else None)
    cc_consulted = compile_cache["hits"] + compile_cache["misses"]
    compile_cache["hit_rate"] = (
        round(compile_cache["hits"] / cc_consulted, 4)
        if cc_consulted else None)
    compile_cache["entries"] = sorted(cc_entries)
    n_req = slo_totals["requests"]
    slo_totals["attainment_pct"] = (
        round(100.0 * (n_req - slo_totals["violations"]) / n_req, 2)
        if n_req else None)

    return {
        "root": str(root),
        "time": now,
        "hosts": entries,
        "n_hosts": {
            "live": sum(1 for e in current if e["state"] == "live"),
            "stalled": sum(1 for e in current if e["state"] == "STALLED"),
            "finished": sum(1 for e in current
                            if e["state"] == "FINISHED"),
            "prior_run": sum(1 for e in entries if e["prior_run"]),
            "unreadable": sum(1 for e in entries
                              if e["state"] == "unreadable"),
        },
        "stragglers": sorted(stragglers),
        "queue": _queue_counts(root, entries),
        "cache": cache,
        "cache_by_family": by_family_cache,
        "compile_cache": compile_cache,
        "capacity_inputs": idle_inputs,
        "families": collect_family_throughput(root),
        "serve": {"hosts": slo_hosts, "totals": slo_totals,
                  "tenants": tenant_totals},
        # active alert episodes (telemetry/alerts.py): rendered, prom'd
        # as ALERTS gauges and gated by --fail-on-alert; evaluation
        # itself belongs to the in-process engines and telemetry/alerts.py
        "alerts": collect_alerts(root),
        # roofline roll-up (telemetry/roofline.py): every host's
        # _roofline*.json merged — flops/forward sums, MFU recomputed
        # over the fleet totals, verdict re-derived; None when no host
        # ran with roofline=true
        "roofline": _roofline_rollup(root),
        # storage accounting: the freshest host's usage snapshot
        # of the shared planes; None when no host ran with gc=true
        "gc": gc_section,
        # recorded traffic drills: each _scenario.json
        # verdict with its windowed SLO-attainment curve
        "scenarios": collect_scenarios(root),
        # certify verdict artifacts (telemetry/parity.py): per-seam
        # numerics error attribution, rendered as == parity == and
        # exported as vft_parity_* gauges; the parity_drift alert rule
        # reads the same collection
        "parity": _parity_verdicts(root),
    }


def _parity_verdicts(root: str) -> List[dict]:
    try:
        from .telemetry.parity import collect_verdicts
        return collect_verdicts(str(root))
    except Exception:
        return []


def _roofline_rollup(root: str) -> Optional[dict]:
    try:
        from .telemetry.roofline import aggregate_rooflines
        return aggregate_rooflines(str(root))
    except Exception:
        return None


# -- capacity decision plane --------------------------------------------------

class CapacityPlanner:
    """Scale-up / scale-down / hold recommendations with hysteresis —
    the *decision* half of elastic capacity (ROADMAP item 3); actuation
    stays with the operator.

    Feed it successive :func:`aggregate` snapshots (``--watch`` does,
    every pass) and it derives three signals:

      - **queue depth per live host** (``queue.pending / live``): work
        is piling up faster than the fleet drains it;
      - **idle-wait stall share**: the fraction of fleet wall-time spent
        in ``fleet.idle_wait`` (hosts starved while siblings hold the
        last leases — more hosts would NOT help; fewer would);
      - **SLO attainment + slope** over the observation window: serving
        below target and not recovering means capacity, not luck, is
        the problem.

    Hysteresis keeps the recommendation actionable instead of flappy: a
    non-``hold`` *pressure* must repeat ``confirm_ticks`` consecutive
    observations before it becomes the recommendation, and once the
    recommendation changes it is pinned for ``cooldown_s`` (scaling
    actions take time to land; re-deciding mid-flight oscillates).
    Thresholds and the clock are injectable for tests.

    **Persistence**: with a ``state_path`` (or via :meth:`for_root`) the
    streak/cooldown/slope state survives restarts of the report —
    without it, every restart reset the hysteresis and a freshly
    relaunched watcher could re-recommend a scale action the previous
    one had just cooled down from. When no state file exists yet, the
    slope baseline seeds from the retained heartbeat history
    (telemetry/history.py), so even the FIRST observation of a new
    watcher has a real window behind it.
    """

    #: recommendation -> prometheus gauge value
    SCALE = {"scale_up": 1, "hold": 0, "scale_down": -1}

    STATE_FILENAME = "_capacity_state.json"
    STATE_SCHEMA = "vft.capacity_state/1"

    def __init__(self, *, slo_target_pct: float = 95.0,
                 up_pending_per_host: float = 2.0,
                 down_idle_share: float = 0.5,
                 confirm_ticks: int = 2, cooldown_s: float = 120.0,
                 clock=time.time,
                 state_path: Optional[str] = None) -> None:
        self.slo_target_pct = float(slo_target_pct)
        self.up_pending_per_host = float(up_pending_per_host)
        self.down_idle_share = float(down_idle_share)
        self.confirm_ticks = max(1, int(confirm_ticks))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.state_path = state_path
        self._prev: Optional[dict] = None  # last observation's raw inputs
        self._want: Optional[str] = None
        self._streak = 0
        self._recommendation = "hold"
        self._last_change: Optional[float] = None
        if state_path is not None:
            self._load_state()

    @classmethod
    def for_root(cls, root: str, **kw) -> "CapacityPlanner":
        """A planner keyed on the fleet root: state in
        ``{root}/_capacity_state.json``, slope baseline seeded from the
        root's retained history when no state file exists yet."""
        p = cls(state_path=os.path.join(str(root), cls.STATE_FILENAME),
                **kw)
        if p._prev is None:
            p._seed_prev_from_history(str(root))
        return p

    # -- persistence --------------------------------------------------------
    def _load_state(self) -> None:
        st = _load_json(str(self.state_path))
        if st is None or st.get("schema") != self.STATE_SCHEMA:
            return
        self._want = st.get("want")
        self._streak = int(st.get("streak") or 0)
        self._recommendation = str(st.get("recommendation") or "hold")
        lc = st.get("last_change")
        self._last_change = float(lc) if lc is not None else None
        prev = st.get("prev")
        self._prev = dict(prev) if isinstance(prev, dict) else None

    def _save_state(self) -> None:
        if self.state_path is None:
            return
        from .telemetry.jsonl import write_json_atomic
        try:
            write_json_atomic(str(self.state_path), {
                "schema": self.STATE_SCHEMA,
                "want": self._want,
                "streak": self._streak,
                "recommendation": self._recommendation,
                "last_change": self._last_change,
                "prev": self._prev,
            })
        except OSError as e:
            print(f"fleet_report: cannot persist capacity state to "
                  f"{self.state_path}: {type(e).__name__}: {e}",
                  file=sys.stderr)

    def _seed_prev_from_history(self, root: str) -> None:
        """Baseline the idle/attainment slopes from the newest retained
        sample per host (telemetry/history.py) — real data instead of a
        null first window."""
        from .telemetry.history import read_history
        series = read_history(root)
        if not series:
            return
        idle = up = req = vio = 0.0
        t_max = None
        for samples in series.values():
            s = samples[-1]
            t = float(s.get("time") or 0.0)
            t_max = t if t_max is None else max(t_max, t)
            fl = s.get("fleet") or {}
            idle += float(fl.get("idle_wait_s_total") or 0.0)
            up += float(s.get("uptime_s") or 0.0)
            slo = s.get("slo") or {}
            req += float(slo.get("requests") or 0)
            vio += float(slo.get("violations") or 0)
        if t_max is None:
            return
        self._prev = {
            "idle_wait_s_total": idle, "uptime_s": up,
            "attainment_pct": (round(100.0 * (req - vio) / req, 2)
                               if req else None),
            "time": t_max,
        }

    # -- signal derivation --------------------------------------------------
    def _signals(self, agg: dict, now: float) -> dict:
        live = int((agg.get("n_hosts") or {}).get("live") or 0)
        q = agg.get("queue")
        pending = claimed = None
        if isinstance(q, dict):
            pending = int(q.get("pending") or 0)
            claimed = int(q.get("claimed") or 0)
        pending_per_host = (round(pending / max(1, live), 3)
                            if pending is not None else None)
        # idle share: prefer the delta between this observation and the
        # last (the live stall rate); first observation falls back to
        # the cumulative share since fleet start
        ci = agg.get("capacity_inputs") or {}
        idle_now = float(ci.get("idle_wait_s_total") or 0.0)
        up_now = float(ci.get("uptime_s") or 0.0)
        idle_share = None
        if ci.get("fleet_hosts"):
            prev = self._prev or {}
            d_idle = idle_now - float(prev.get("idle_wait_s_total", 0.0))
            d_up = up_now - float(prev.get("uptime_s", 0.0))
            if self._prev is not None and d_up > 0.5:
                idle_share = max(0.0, min(1.0, d_idle / d_up))
            elif up_now > 0:
                idle_share = max(0.0, min(1.0, idle_now / up_now))
        att = (agg.get("serve") or {}).get("totals", {}) \
            .get("attainment_pct")
        att = float(att) if att is not None else None
        slope = None
        if att is not None and self._prev is not None and \
                self._prev.get("attainment_pct") is not None:
            dt_min = (now - float(self._prev["time"])) / 60.0
            if dt_min > 1e-3:
                slope = round(
                    (att - float(self._prev["attainment_pct"])) / dt_min, 3)
        return {"live": live, "pending": pending, "claimed": claimed,
                "pending_per_host": pending_per_host,
                "idle_share": (round(idle_share, 4)
                               if idle_share is not None else None),
                "attainment_pct": att,
                "attainment_slope_pct_per_min": slope,
                "idle_wait_s_total": idle_now, "uptime_s": up_now,
                "time": now}

    def _pressure(self, s: dict) -> Tuple[str, List[str]]:
        reasons: List[str] = []
        want = "hold"
        if s["pending"] and not s["live"]:
            return "scale_up", [f"{s['pending']} item(s) pending with no "
                                "live host"]
        if s["pending_per_host"] is not None and \
                s["pending_per_host"] >= self.up_pending_per_host:
            want = "scale_up"
            reasons.append(f"queue depth {s['pending_per_host']}/host >= "
                           f"{self.up_pending_per_host}")
        if s["attainment_pct"] is not None and \
                s["attainment_pct"] < self.slo_target_pct and \
                (s["attainment_slope_pct_per_min"] is None
                 or s["attainment_slope_pct_per_min"] <= 0):
            want = "scale_up"
            reasons.append(
                f"SLO attainment {s['attainment_pct']}% < "
                f"{self.slo_target_pct}% and not recovering "
                f"(slope {s['attainment_slope_pct_per_min']}%/min)")
        if want == "hold" and s["live"] > 1 and s["pending"] == 0 and \
                (s["claimed"] or 0) == 0 and s["idle_share"] is not None \
                and s["idle_share"] >= self.down_idle_share:
            want = "scale_down"
            reasons.append(f"queue drained and idle-wait share "
                           f"{s['idle_share']:.0%} >= "
                           f"{self.down_idle_share:.0%}")
        if not reasons:
            reasons.append("signals inside bands")
        return want, reasons

    # -- the observation step ----------------------------------------------
    def observe(self, agg: dict, now: Optional[float] = None) -> dict:
        now = self.clock() if now is None else float(now)
        s = self._signals(agg, now)
        want, reasons = self._pressure(s)
        if want == self._want:
            self._streak += 1
        else:
            self._want, self._streak = want, 1
        flipped = False
        if want != self._recommendation:
            confirmed = self._streak >= self.confirm_ticks
            cooled = (self._last_change is None
                      or now - self._last_change >= self.cooldown_s)
            if confirmed and cooled:
                self._recommendation = want
                self._last_change = now
                flipped = True
            elif confirmed and not cooled:
                reasons.append(
                    f"pinned by cooldown ({self.cooldown_s:.0f}s since "
                    "last change not elapsed)")
            else:
                reasons.append(
                    f"awaiting confirmation ({self._streak}/"
                    f"{self.confirm_ticks} consecutive)")
        self._prev = {"idle_wait_s_total": s["idle_wait_s_total"],
                      "uptime_s": s["uptime_s"],
                      "attainment_pct": s["attainment_pct"], "time": now}
        self._save_state()
        out = {"recommendation": self._recommendation,
               "pressure": want, "streak": self._streak,
               "changed": flipped, "reasons": reasons}
        out.update({k: s[k] for k in ("live", "pending", "claimed",
                                      "pending_per_host", "idle_share",
                                      "attainment_pct",
                                      "attainment_slope_pct_per_min")})
        return out


def render_capacity(rec: dict) -> List[str]:
    lines = [f"== capacity ==  recommendation="
             f"{rec['recommendation'].upper()}"
             + (f"  (pressure={rec['pressure']} x{rec['streak']})"
                if rec["pressure"] != rec["recommendation"] else "")]
    sig = (f"  signals: live={rec['live']}")
    if rec.get("pending") is not None:
        sig += (f" pending={rec['pending']} "
                f"({rec['pending_per_host']}/host)")
    if rec.get("idle_share") is not None:
        sig += f" idle_share={rec['idle_share']:.0%}"
    if rec.get("attainment_pct") is not None:
        sig += f" slo_attainment={rec['attainment_pct']}%"
        if rec.get("attainment_slope_pct_per_min") is not None:
            sig += f" (slope {rec['attainment_slope_pct_per_min']}%/min)"
    lines.append(sig)
    for r in rec.get("reasons", []):
        lines.append(f"  - {r}")
    return lines


# -- rendering ----------------------------------------------------------------

def render(agg: dict, capacity: Optional[dict] = None) -> List[str]:
    lines = [f"fleet report: {agg['root']}"]
    n = agg["n_hosts"]
    lines.append(
        f"== hosts ==  {n['live']} live / {n['stalled']} stalled / "
        f"{n['finished']} finished"
        + (f" / {n['prior_run']} prior-run (ignored)"
           if n["prior_run"] else "")
        + (f" / {n['unreadable']} unreadable" if n["unreadable"] else ""))
    for e in agg["hosts"]:
        hb = e.get("hb")
        if hb is None:
            lines.append(f"  {os.path.basename(e['path'])}: unreadable")
            continue
        if e["prior_run"]:
            lines.append(f"  {hb.get('host_id')}: PRIOR RUN "
                         f"(run_id={hb.get('run_id')}) — ignored")
            continue
        tag = {"live": "alive", "STALLED": "STALLED?",
               "FINISHED": "FINISHED"}[e["state"]]
        line = (f"  {hb.get('host_id')}: {tag}  "
                f"age={_fmt_age(e['age_s'])}  "
                f"done={hb.get('videos_done', 0)}  "
                f"videos/s={hb.get('videos_per_s')}")
        fl = hb.get("fleet")
        if isinstance(fl, dict):
            line += (f"  [fleet claimed={fl.get('claimed', 0)} "
                     f"done={fl.get('done', 0)} "
                     f"stolen={fl.get('stolen', 0)} "
                     f"active={fl.get('active_claims', 0)}]")
        if str(hb.get("host_id")) in agg["stragglers"]:
            line += "  STRAGGLER (fleet idle behind this host)"
        lines.append(line)
    if agg.get("alerts"):
        from .telemetry.alerts import render_alerts
        lines += render_alerts(agg["alerts"])
    if agg["queue"] is not None:
        q = agg["queue"]
        lines.append(
            f"== fleet queue ==  pending={q.get('pending', 0)}  "
            f"claimed={q.get('claimed', 0)}  done={q.get('done', 0)}"
            + (f"  quarantined={q['quarantined']}"
               if q.get("quarantined") else ""))
    ca = agg["cache"]
    if any(ca.get(k) for k in ("hits", "misses", "bypasses")):
        lines.append(
            f"== cache ==  hits={ca['hits']}  misses={ca['misses']}  "
            f"bypasses={ca['bypasses']}"
            + (f"  hit_rate={ca['hit_rate']}"
               if ca.get("hit_rate") is not None else ""))
    cc = agg.get("compile_cache") or {}
    if cc.get("attached_hosts") or cc.get("hits") or cc.get("misses"):
        lines.append(
            f"== compile cache ==  hits={cc.get('hits', 0)}  "
            f"misses={cc.get('misses', 0)}  "
            f"warm_hosts={cc.get('warm_hosts', 0)}/"
            f"{cc.get('attached_hosts', 0)}"
            + (f"  dropped={cc['dropped']}" if cc.get("dropped") else "")
            + (f"  entries={','.join(cc['entries'])}"
               if cc.get("entries") else ""))
    rf = agg.get("roofline")
    if rf and rf.get("families"):
        from .telemetry.roofline import render_verdict
        dev = rf.get("device") or {}
        parts = []
        for fam, f in sorted(rf["families"].items()):
            mfu = f.get("mfu")
            parts.append(
                f"{fam} mfu="
                + (f"{100 * mfu:.1f}%" if mfu is not None else "?")
                + f" {render_verdict(f.get('verdict'))}")
        lines.append(
            f"== roofline ==  peak={dev.get('peak_tflops')} TFLOPS "
            f"[{dev.get('source')}]  " + "; ".join(parts)
            + "  (python -m video_features_tpu_torch.telemetry.roofline "
              "for the full table)")
    gc = agg.get("gc")
    if isinstance(gc, dict):
        used = float(gc.get("used_bytes") or 0)
        quota = gc.get("quota_bytes")
        line = f"== storage ==  used={used / 1e9:.2f}GB"
        if quota:
            line += (f"  quota={float(quota) / 1e9:.2f}GB "
                     f"({100.0 * used / float(quota):.0f}%)")
        planes = gc.get("planes") or {}
        top = sorted(planes.items(), key=lambda kv: -float(kv[1] or 0))
        if top:
            line += "  " + " ".join(
                f"{p}={float(b or 0) / 1e9:.2f}GB" for p, b in top[:4])
        lines.append(line + "  (the gc report: ROADMAP.md Queue 1 #8)")
    if capacity is not None:
        lines += render_capacity(capacity)
    fams = agg["families"]
    if fams:
        lines.append("== per-family throughput (fleet-wide spans) ==")
        for fam, f in sorted(fams.items()):
            lines.append(
                f"  {fam:<10} done={f['done']:<6} error={f['error']:<4}"
                + (f" {f['s_per_video']}s/video"
                   if f.get("s_per_video") is not None else ""))
    serve = agg["serve"]
    if serve["hosts"]:
        t = serve["totals"]
        lines.append(
            f"== serve SLO ==  requests={t['requests']}  "
            f"violations={t['violations']}"
            + (f"  attainment={t['attainment_pct']}%"
               if t.get("attainment_pct") is not None else ""))
        for h in serve["hosts"]:
            slo = h["slo"]
            svc = slo.get("service") or {}
            qw = slo.get("queue_wait") or {}
            line = (f"  {h['host_id']}: {h.get('state')}  "
                    f"pending={h.get('pending')}  "
                    f"inflight={h.get('inflight')}")
            if slo.get("requests"):
                line += (f"  service p50/p95/p99="
                         f"{svc.get('p50')}/{svc.get('p95')}/"
                         f"{svc.get('p99')}s"
                         f"  wait p95={qw.get('p95')}s")
                if slo.get("slo_s") is not None:
                    line += (f"  slo={slo['slo_s']}s "
                             f"violations={slo.get('violations', 0)}"
                             f" attainment={slo.get('attainment_pct')}%")
            lines.append(line)
    tenants = serve.get("tenants") or {}
    if tenants:
        lines.append("== tenants ==")
        for t, tt in sorted(tenants.items()):
            line = (f"  {t:<12} requests={tt.get('requests', 0):<6} "
                    f"violations={tt.get('violations', 0):<4} "
                    f"rejects={tt.get('rejects', 0)}")
            if tt.get("attainment_pct") is not None:
                line += f"  attainment={tt['attainment_pct']}%"
            lines.append(line)
    for sc in agg.get("scenarios") or []:
        lines += render_scenario(sc)
    for pv in agg.get("parity") or []:
        lines += render_parity(pv)
    return lines


def render_parity(pv: dict) -> List[str]:
    """The ``== parity ==`` block for one certify verdict: the flip
    under certification, PASS/FAIL, and one max_abs/band + cos/floor
    entry per seam in pipeline order — a FAIL leads with the first
    drifted seam, the attribution the observatory exists for."""
    from .telemetry.parity import SEAMS
    head = (f"== parity ==  {pv.get('family')}"
            + (f" flip={pv.get('flip')}" if pv.get("flip") else "")
            + f": {pv.get('verdict')}")
    if pv.get("first_drift"):
        head += f"  first_drift={pv['first_drift']}"
    parts = []
    for seam in SEAMS:
        m = (pv.get("seams") or {}).get(seam)
        if not isinstance(m, dict):
            continue
        mark = "" if m.get("ok") else "!"
        parts.append(f"{mark}{seam}={m.get('max_abs')}/"
                     f"{m.get('tol_max_abs')}")
    if parts:
        head += "  " + " ".join(parts)
    return [head + "  (python -m video_features_tpu_torch parity for the "
            "full table)"]


_SPARK = "▁▂▃▄▅▆▇█"


def _spark(vals: List[Optional[float]]) -> str:
    """Attainment-curve sparkline: 0..100% maps onto 8 block heights
    (absolute scale, so two drills' curves compare at a glance); a
    window with no admitted traffic renders as '·'."""
    out = []
    for v in vals:
        if v is None:
            out.append("·")
        else:
            out.append(_SPARK[max(0, min(7, int(float(v) / 100.0 * 7.999)))])
    return "".join(out)


def render_scenario(sc: dict) -> List[str]:
    """The ``== scenarios ==`` block for one drill verdict: headline
    tallies, then one line per tenant with its windowed SLO-attainment
    curve over the scenario timeline."""
    lines = [f"== scenarios ==  {sc.get('scenario')}: "
             f"{sc.get('verdict')}  "
             f"offered={sc.get('offered', 0)}  "
             f"admitted={sc.get('admitted', 0)}  "
             f"completed={sc.get('completed', 0)}  "
             f"expired={sc.get('expired', 0)}  "
             f"429={sc.get('rejected', 0)}  shed={sc.get('shed', 0)}"
             + (f"  [audit FAIL]"
                if not (sc.get("audit") or {}).get("pass", True) else "")]
    curve = sc.get("curve") or []
    for t, tb in sorted((sc.get("tenants") or {}).items()):
        vals = [(w.get("tenants") or {}).get(t, {}).get("attainment_pct")
                for w in curve]
        line = (f"  {t:<12} attainment="
                + (f"{tb['attainment_pct']}%"
                   if tb.get("attainment_pct") is not None else "n/a"))
        if curve:
            line += (f"  curve={_spark(vals)} "
                     f"({curve[0].get('t1', 0)}s windows, virtual)")
        lines.append(line)
    unmet = [o for o in sc.get("objectives") or [] if not o.get("met")]
    for o in unmet:
        what = next((k for k in o if k.startswith(("min_", "max_"))), "?")
        scope = f"tenant={o['tenant']} " if o.get("tenant") else ""
        lines.append(f"  UNMET: {scope}{what}={o.get(what)} "
                     f"actual={o.get('actual')}")
    return lines


# -- prometheus export --------------------------------------------------------

def build_prom_dump(agg: dict, capacity: Optional[dict] = None) -> dict:
    """Fleet-level gauges in the telemetry/metrics.py dump shape, so
    :func:`prometheus_text` renders them — one textfile for the whole
    fleet next to the per-host ones telemetry/report.py exports."""
    series: List[dict] = []

    def g(name: str, value, **labels) -> None:
        if value is None:
            return
        series.append({"name": name, "kind": "gauge",
                       "labels": {k: str(v) for k, v in labels.items()},
                       "value": float(value)})

    for state, count in agg["n_hosts"].items():
        g("vft_fleet_hosts", count, state=state)
    for e in agg["hosts"]:
        hb = e.get("hb")
        if hb is None or e["prior_run"]:
            continue
        g("vft_fleet_videos_done", hb.get("videos_done", 0),
          host_id=hb.get("host_id"))
        g("vft_fleet_videos_per_s", hb.get("videos_per_s", 0.0),
          host_id=hb.get("host_id"))
    for h in agg["stragglers"]:
        g("vft_fleet_straggler", 1, host_id=h)
    if agg["queue"] is not None:
        for k, v in agg["queue"].items():
            g("vft_fleet_queue_items", v, bucket=k)
    ca = agg["cache"]
    for k in ("hits", "misses", "bypasses"):
        g(f"vft_fleet_cache_{k}_total", ca.get(k, 0))
    g("vft_fleet_cache_hit_rate", ca.get("hit_rate"))
    cc = agg.get("compile_cache") or {}
    for k in ("hits", "misses"):
        g(f"vft_fleet_compile_cache_{k}_total", cc.get(k, 0))
    g("vft_fleet_compile_cache_hit_rate", cc.get("hit_rate"))
    g("vft_fleet_compile_cache_warm_hosts", cc.get("warm_hosts", 0))
    if capacity is not None:
        g("vft_fleet_capacity_recommendation",
          CapacityPlanner.SCALE.get(capacity["recommendation"], 0))
        g("vft_fleet_capacity_pressure",
          CapacityPlanner.SCALE.get(capacity["pressure"], 0))
        g("vft_fleet_capacity_pending_per_host",
          capacity.get("pending_per_host"))
        g("vft_fleet_capacity_idle_share", capacity.get("idle_share"))
    rf = agg.get("roofline")
    if rf:
        for fam, f in (rf.get("families") or {}).items():
            g("vft_roofline_mfu", f.get("mfu"), family=fam)
            g("vft_roofline_effective_tflops", f.get("effective_tflops"),
              family=fam)
            g("vft_roofline_dispatches_total", f.get("dispatches"),
              family=fam)
        g("vft_roofline_peak_tflops",
          (rf.get("device") or {}).get("peak_tflops"))
    gc = agg.get("gc")
    if isinstance(gc, dict):
        g("vft_gc_used_bytes", gc.get("used_bytes"))
        if gc.get("quota_bytes"):
            g("vft_gc_quota_bytes", gc["quota_bytes"])
        for plane, b in sorted((gc.get("planes") or {}).items()):
            g("vft_gc_plane_bytes", b, plane=plane)
        for tenant, b in sorted((gc.get("tenants") or {}).items()):
            g("vft_gc_tenant_bytes", b, tenant=tenant)
    for fam, f in agg["families"].items():
        g("vft_fleet_family_done", f["done"], family=fam)
        g("vft_fleet_family_errors", f["error"], family=fam)
        g("vft_fleet_family_s_per_video", f.get("s_per_video"),
          family=fam)
    t = agg["serve"]["totals"]
    g("vft_fleet_serve_requests_total", t["requests"])
    g("vft_fleet_serve_slo_violations_total", t["violations"])
    g("vft_fleet_serve_slo_attainment_pct", t.get("attainment_pct"))
    for name, tt in sorted((agg["serve"].get("tenants") or {}).items()):
        g("vft_tenant_requests_total", tt.get("requests", 0), tenant=name)
        g("vft_tenant_rejects_total", tt.get("rejects", 0), tenant=name)
        g("vft_tenant_slo_violations_total", tt.get("violations", 0),
          tenant=name)
        g("vft_tenant_slo_attainment_pct", tt.get("attainment_pct"),
          tenant=name)
    for h in agg["serve"]["hosts"]:
        # both splits of the per-host SLO block: service alone would hide
        # queue-wait regressions from the prom view
        svc = (h["slo"].get("service") or {})
        qw = (h["slo"].get("queue_wait") or {})
        for p in ("p50", "p95", "p99"):
            g("vft_fleet_serve_service_seconds", svc.get(p),
              host_id=h["host_id"], quantile=p)
            g("vft_fleet_serve_queue_wait_seconds", qw.get(p),
              host_id=h["host_id"], quantile=p)
    for sc in agg.get("scenarios") or []:
        name = sc.get("scenario")
        g("vft_scenario_pass", 1 if sc.get("verdict") == "PASS" else 0,
          scenario=name)
        for k in ("offered", "admitted", "completed", "expired",
                  "rejected", "shed"):
            g(f"vft_scenario_{k}", sc.get(k, 0), scenario=name)
        for t, tb in sorted((sc.get("tenants") or {}).items()):
            g("vft_scenario_attainment_pct", tb.get("attainment_pct"),
              scenario=name, tenant=t)
    for pv in agg.get("parity") or []:
        fam = pv.get("family")
        flip = pv.get("flip") or "none"
        g("vft_parity_verdict_pass",
          1 if pv.get("verdict") == "PASS" else 0, family=fam, flip=flip)
        for seam, m in sorted((pv.get("seams") or {}).items()):
            if isinstance(m, dict):
                g("vft_parity_seam_error", m.get("max_abs"),
                  family=fam, seam=seam)
    if agg.get("alerts"):
        # ALERTS{alertname, alertstate, severity, scope} 1 — the exact
        # series shape Prometheus-native alert evaluators export, so
        # existing Alertmanager routing consumes the fleet's alerts with
        # zero translation (telemetry/alerts.py)
        from .telemetry.alerts import alerts_prom_series
        series.extend(alerts_prom_series(agg["alerts"]))
    return {"series": series}


# -- trace stitching ----------------------------------------------------------

def find_trace_files(root: str) -> List[Path]:
    """Every trace artifact under ``root``: ``_trace.json``
    (single-writer dirs) plus the per-host ``_trace_{host_id}.json``
    fleet workers and serve siblings write — excluding stitched/merged
    OUTPUT files, which must never feed back in as inputs."""
    return [p for p in sorted(Path(root).rglob("_trace*.json"))
            if p.name not in TRACE_OUTPUT_NAMES and not _in_incident(p)]


def _host_label(doc: dict, trace_dir: str) -> str:
    """Lane name for one host's trace: the recorder's own host_id stamp
    when present, else the heartbeat host_id that shares the trace's
    directory (pid-qualified, fleet-unique), else host+pid metadata."""
    other = doc.get("otherData") or {}
    if other.get("host_id"):
        return str(other["host_id"])
    pid = other.get("pid")
    candidates = sorted(_glob.glob(os.path.join(trace_dir,
                                                HEARTBEAT_GLOB)))
    ids = []
    for p in candidates:
        hb = _load_json(p)
        if hb is None:
            continue
        if pid is not None and hb.get("pid") == pid:
            return str(hb.get("host_id"))
        ids.append(str(hb.get("host_id")))
    if len(ids) == 1:
        return ids[0]
    host = other.get("host") or "host"
    return f"{host}-{pid}" if pid is not None else str(host)


def stitch_traces(docs: List[Tuple[str, dict]]) -> dict:
    """Merge N hosts' trace docs into one Chrome-trace file on one
    wall-clock timeline.

    ``docs`` is ``[(lane_label, doc), ...]``. Each doc's events keep
    every field (the per-``ph`` required sets check_trace_schema pins)
    except: ``ts`` shifts by the doc's wall-clock anchor offset against
    the earliest anchor, and ``pid`` remaps to a per-host value so
    Perfetto renders one process group per host, titled with the lane
    label. Docs without an anchor stay at offset 0 (aligned to the
    earliest-anchored host's start) and are listed in
    ``otherData.unanchored``."""
    anchors = [
        (doc.get("otherData") or {}).get("start_unix") for _, doc in docs]
    known = [float(a) for a in anchors if isinstance(a, (int, float))]
    t0 = min(known) if known else None
    events: List[dict] = []
    hosts: List[dict] = []
    unanchored: List[str] = []
    for i, (label, doc) in enumerate(docs):
        pid = STITCH_PID_BASE + i
        anchor = anchors[i]
        offset_us = (float(anchor) - t0) * 1e6 \
            if isinstance(anchor, (int, float)) and t0 is not None else 0.0
        if not isinstance(anchor, (int, float)):
            unanchored.append(label)
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": label}})
        for ev in doc.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the host lane title above
            ev = dict(ev)
            ev["pid"] = pid
            if isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(ev["ts"] + offset_us, 3)
            events.append(ev)
        hosts.append({"host_id": label, "pid": pid,
                      "start_unix": anchor,
                      "offset_ms": round(offset_us / 1e3, 3)})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": STITCH_SCHEMA,
            "hosts": hosts,
            "anchor_unix": t0,
            "unanchored": unanchored,
            "aligned": bool(known) and not unanchored,
        },
    }


def stitch(root: str, out_path: Optional[str] = None
           ) -> Tuple[Optional[str], dict]:
    """Find every ``_trace.json`` under ``root``, stitch, write.
    Returns ``(written path or None, stitched doc)``."""
    found = find_trace_files(root)
    docs: List[Tuple[str, dict]] = []
    for p in found:
        doc = _load_json(str(p))
        if doc is None or not isinstance(doc.get("traceEvents"), list):
            print(f"fleet_report: skipping unreadable/non-trace {p}",
                  file=sys.stderr)
            continue
        docs.append((_host_label(doc, str(p.parent)), doc))
    if not docs:
        return None, {"traceEvents": [], "otherData": {
            "schema": STITCH_SCHEMA, "hosts": [], "anchor_unix": None,
            "unanchored": [], "aligned": False}}
    merged = stitch_traces(docs)
    out = out_path or os.path.join(str(root), "_trace_fleet.json")
    from .utils.sinks import _write_bytes_atomic
    # the stitched trace lands in the shared fleet root: atomic, so a
    # concurrently-watching Perfetto reader never loads a torn document
    _write_bytes_atomic(out, json.dumps(merged).encode("utf-8"))
    return out, merged


# -- request lookup -----------------------------------------------------------

def find_request(root: str, request_id: str) -> List[str]:
    """Every artifact record one request produced, fleet-wide: span
    records, health digests, failure-journal entries, trace spans, the
    spool request/response files and fleet-queue claims carrying the id
    (telemetry/context.py stamps them all in serve mode)."""
    rid = str(request_id)
    hits: List[str] = []
    root_p = Path(root)
    for name, kind in ((SPANS_FILENAME, "span"), (HEALTH_FILENAME,
                       "health"), (FAILURES_FILENAME, "failure")):
        for path in sorted(root_p.rglob(name)):
            if _in_incident(path):
                continue
            for rec in read_jsonl(path):
                if rec.get("request_id") == rid or rec.get("id") == rid:
                    tail = (f"status={rec.get('status')}" if kind == "span"
                            else f"key={rec.get('key')} sig="
                                 f"{str(rec.get('sig'))[:12]}"
                            if kind == "health"
                            else f"category={rec.get('category')}")
                    hits.append(f"{kind}  {path}  video="
                                f"{rec.get('video')}  {tail}")
    for path in find_trace_files(root):
        doc = _load_json(str(path))
        if doc is None:
            continue
        for ev in doc.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            args = ev.get("args") or {}
            if rid in (args.get("request"), args.get("id"),
                       args.get("request_id")):
                hits.append(f"trace  {path}  {ev.get('name')} "
                            f"ts={ev.get('ts')} dur={ev.get('dur')}")
    for sub in ("requests", "done"):
        for path in sorted(root_p.rglob(os.path.join(sub,
                                                     f"{rid}.json"))):
            hits.append(f"spool  {path}")
    for path in sorted(root_p.rglob("*.json")):
        if "_queue" not in path.parts and "claimed" not in path.parts:
            continue
        rec = _load_json(str(path))
        if rec is not None and rid in (rec.get("request_id"),
                                       rec.get("id")):
            hits.append(f"claim  {path}  host={rec.get('host_id')}")
    return hits


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="one-view fleet report over a shared out_root/spool")
    ap.add_argument("root", help="the fleet's shared output root (or a "
                                 "serving spool dir)")
    ap.add_argument("--watch", action="store_true",
                    help="live refresh until interrupted")
    ap.add_argument("--every", type=float, default=2.0,
                    help="--watch refresh period in seconds (default 2)")
    ap.add_argument("--iterations", type=int, default=0,
                    help="--watch passes before exiting (0 = forever; "
                         "1 = single-pass, for scripts/tests)")
    ap.add_argument("--prom", metavar="FILE", default=None,
                    help="write a fleet-level Prometheus textfile")
    ap.add_argument("--stitch", nargs="?", const="", metavar="OUT",
                    default=None,
                    help="merge every host's _trace.json into one "
                         "wall-clock-aligned Perfetto file (default "
                         "{root}/_trace_fleet.json)")
    ap.add_argument("--request", metavar="ID", default=None,
                    help="print every artifact record one request id "
                         "produced, fleet-wide")
    ap.add_argument("--fail-on-alert", action="store_true",
                    help="exit 1 while any alert episode is firing "
                         "(prior-run excluded) — the fleet-level twin of "
                         "telemetry/report.py's gate (telemetry/alerts.py)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"error: {args.root} is not a directory", file=sys.stderr)
        return 2

    if args.request:
        hits = find_request(args.root, args.request)
        if not hits:
            print(f"request {args.request}: no artifacts under "
                  f"{args.root}")
            return 1
        print(f"request {args.request}: {len(hits)} record(s)")
        for h in hits:
            print(f"  {h}")
        return 0

    # capacity decision plane: one planner across every --watch pass,
    # PERSISTED at the root (`_capacity_state.json`) so hysteresis,
    # cooldown and the slope baseline survive watcher restarts — and
    # seeded from the retained history series when starting fresh
    planner = CapacityPlanner.for_root(args.root)
    capacity = None
    agg = None
    passes = 0
    while True:
        agg = aggregate(args.root)
        capacity = planner.observe(agg)
        text = "\n".join(render(agg, capacity=capacity))
        if args.watch and passes > 0:
            # ANSI clear+home: the operator's top(1) for the fleet
            sys.stdout.write("\x1b[2J\x1b[H")
        print(text)
        passes += 1
        if not args.watch or (args.iterations and
                              passes >= args.iterations):
            break
        try:
            time.sleep(max(0.05, args.every))
        except KeyboardInterrupt:
            break

    if args.prom:
        agg = aggregate(args.root)
        capacity = planner.observe(agg)
        dump = build_prom_dump(agg, capacity=capacity)
        from .utils.sinks import _write_bytes_atomic
        # the node-exporter textfile collector reads on its own cadence:
        # the textfile convention is write-temp-then-rename for a reason
        _write_bytes_atomic(args.prom,
                            prometheus_text(dump).encode("utf-8"))
        print(f"prometheus textfile: {args.prom} "
              f"({len(dump['series'])} series)")
    if args.stitch is not None:
        out = args.stitch or None
        path, merged = stitch(args.root, out)
        other = merged.get("otherData", {})
        if path is None:
            print(f"stitch: no {TRACE_FILENAME} under {args.root} — "
                  "run hosts with trace=true", file=sys.stderr)
            return 1
        print(f"stitched fleet trace: {path} "
              f"({len(merged['traceEvents'])} events, "
              f"{len(other.get('hosts', []))} host lane(s), "
              + ("wall-clock aligned" if other.get("aligned")
                 else "UNALIGNED — unanchored traces present")
              + ") — open in https://ui.perfetto.dev")
    if args.fail_on_alert:
        firing = [a for a in (agg or {}).get("alerts") or []
                  if a.get("state") == "firing"]
        if firing:
            print("fail-on-alert: "
                  + ", ".join(f"{a['rule']}({a['scope']})"
                              for a in firing), file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
