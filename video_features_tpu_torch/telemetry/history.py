"""Durable, downsampled retention of per-host heartbeat series (port of
``video_features_tpu/telemetry/history.py``).

A heartbeat is overwritten in place every ``metrics_interval_s``: it says
whether a host is alive now, and nothing about the ticks that explained an
incident five minutes ago. With ``history=true`` (or ``alerts=true``) each
heartbeat tick also appends a compact sample to
``{output_path}/_history_{host_id}.jsonl``, so

  - multi-window SLO burn rates and spike windows are deltas between real
    samples (:func:`window_delta`, :func:`window_rate`), read by
    ``telemetry/alerts.py``;
  - ``fleet_report.py CapacityPlanner`` seeds its slope inputs from here
    when it starts without a state file;
  - the MFU-regression rule compares a family against its own history.

Tiered downsampling (:data:`TIERS`) keeps a week of 2-second ticks
bounded; :class:`HistoryWriter` rewrites the file atomically every
:data:`COMPACT_EVERY` appends. A history file has one writer (the host id is
in its name, as for heartbeats), so the rewrite races no other producer;
:func:`read_history` tolerates a torn tail like every jsonl reader.

A sample is a pure function of the heartbeat the recorder just wrote
(:func:`sample_from_heartbeat`): the retained series is what a live
observer saw, with no second measurement path. The on-disk format is the
JAX package's, so either package's readers read either's files.
"""
from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import jsonl

HISTORY_PREFIX = "_history_"
HISTORY_GLOB = HISTORY_PREFIX + "*.jsonl"

SAMPLE_SCHEMA = "vft.history_sample/1"

#: tiered retention: ``(max_age_s, keep_one_per_s)`` — samples younger
#: than the first bound keep full resolution (period 0); each older tier
#: thins to one sample per period; anything past the last bound is
#: dropped. A 2s-tick host retains ~300 + 120 + 288 + 336 ≈ 1k samples
#: for a full week instead of ~300k.
TIERS: Tuple[Tuple[float, float], ...] = (
    (600.0, 0.0),         # last 10 min: every tick
    (3600.0, 30.0),       # last hour: one per 30 s
    (86400.0, 300.0),     # last day: one per 5 min
    (7 * 86400.0, 1800.0),  # last week: one per 30 min
)

#: appends between compaction passes (amortizes the atomic rewrite)
COMPACT_EVERY = 256


def history_filename(host_id: str) -> str:
    """``_history_{host_id}.jsonl``, filesystem-sanitized like the
    heartbeat filename (host ids embed hostnames and pids)."""
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(host_id))
    return f"{HISTORY_PREFIX}{safe}.jsonl"


# -- sampling ----------------------------------------------------------------

def _num(v, default=0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _attainment(requests: int, violations: int) -> Optional[float]:
    if not requests:
        return None
    return round(100.0 * (requests - violations) / requests, 2)


def sample_from_heartbeat(hb: dict,
                          nonfinite_total: Optional[int] = None) -> dict:
    """Compact, JSON-safe sample off one heartbeat dict: cumulative
    counters the alert windows diff (requests/violations, cache and
    compile-cache tallies, fleet reclaim/quarantine counts, videos by
    status) plus instantaneous gauges (queue depths, MFU per family).
    ``nonfinite_total`` comes from the recorder's health roll-up — the
    heartbeat itself doesn't carry it."""
    sample: Dict[str, object] = {
        "schema": SAMPLE_SCHEMA,
        "time": _num(hb.get("time"), time.time()),
        "host_id": hb.get("host_id"),
        "run_id": hb.get("run_id"),
        "uptime_s": _num(hb.get("uptime_s")),
        "final": bool(hb.get("final")),
        # stable keys materialized at 0: a counter that first appears
        # mid-run would otherwise have no baseline sample, and the spike
        # windows would read "no data" instead of "it was zero"
        "videos": {k: int((hb.get("videos") or {}).get(k) or 0)
                   for k in ("done", "skipped", "error", "quarantined")},
        "videos_done": int(hb.get("videos_done") or 0),
        "videos_per_s": _num(hb.get("videos_per_s")),
    }
    if nonfinite_total is not None:
        sample["nonfinite_total"] = int(nonfinite_total)
    ca = hb.get("cache") or {}
    if any((ca.get(k) or {}) for k in ("hits", "misses", "bypasses")):
        sample["cache"] = {
            "hits": sum(int(v) for v in (ca.get("hits") or {}).values()),
            "misses": sum(int(v) for v in (ca.get("misses") or {}).values()),
            "bypasses": sum(int(v)
                            for v in (ca.get("bypasses") or {}).values()),
        }
    cc = hb.get("compile_cache") or {}
    if cc:
        sample["compile_cache"] = {"hits": int(cc.get("hits") or 0),
                                   "misses": int(cc.get("misses") or 0)}
    fl = hb.get("fleet")
    if isinstance(fl, dict):
        q = fl.get("queue") or {}
        sample["fleet"] = {
            "active_claims": int(fl.get("active_claims") or 0),
            "stolen": int(fl.get("stolen") or 0),
            "reclaimed": int(fl.get("reclaimed") or 0),
            "quarantined": int(fl.get("quarantined") or 0),
            "idle_wait_s_total": _num(fl.get("idle_wait_s_total")),
            "queue": {k: int(q.get(k) or 0)
                      for k in ("pending", "claimed", "done",
                                "quarantined")},
        }
    serve = hb.get("serve")
    if isinstance(serve, dict):
        slo = serve.get("slo") or {}
        sample["slo"] = {
            "slo_s": slo.get("slo_s"),
            "requests": int(slo.get("requests") or 0),
            "violations": int(slo.get("violations") or 0),
        }
        sample["serve_pending"] = int(serve.get("pending") or 0)
        tens = serve.get("tenants")
        if isinstance(tens, dict) and tens:
            # per-tenant cumulative counters, which the tenant-scoped SLO
            # burn windows diff (telemetry/alerts.py), with the cumulative
            # attainment beside them; tenant names are [a-z0-9_]+, so the
            # dotted-path reader (`_field`) addresses them safely
            sample["tenants"] = {
                str(t): {"requests": int(v.get("requests") or 0),
                         "violations": int(v.get("violations") or 0),
                         "attainment_pct": _attainment(
                             int(v.get("requests") or 0),
                             int(v.get("violations") or 0))}
                for t, v in tens.items()}
    rf = hb.get("roofline") or {}
    fams = rf.get("families") if isinstance(rf, dict) else None
    if fams:
        sample["mfu"] = {fam: f.get("mfu") for fam, f in fams.items()
                         if isinstance(f, dict)}
    gc = hb.get("gc")
    if isinstance(gc, dict):
        # storage accounting (the heartbeat's gc section): the
        # disk_pressure rule reads used/quota levels and diffs used_bytes
        # across windows to project time-to-full
        sample["gc"] = {
            "used_bytes": int(gc.get("used_bytes") or 0),
            "quota_bytes": (int(gc["quota_bytes"])
                            if gc.get("quota_bytes") else None),
        }
    return sample


# -- tiered downsampling -----------------------------------------------------

def downsample(samples: Sequence[dict],
               now: Optional[float] = None, *,
               tiers: Sequence[Tuple[float, float]] = TIERS) -> List[dict]:
    """Apply ``tiers`` (default :data:`TIERS`) to a time-sorted sample
    list: within each tier, keep the LAST sample of every
    ``period``-wide bucket (the freshest state of that interval —
    windowed deltas read end-of-bucket counters); drop samples older
    than the final tier. A pure function, so tests drive it with a fake
    clock."""
    now = time.time() if now is None else float(now)
    kept: List[dict] = []
    buckets_seen: Dict[Tuple[int, int], int] = {}
    ordered = sorted(samples, key=lambda s: _num(s.get("time")))
    # walk newest -> oldest so "keep the last per bucket" is "keep the
    # first encountered", then restore chronological order at the end
    for s in reversed(ordered):
        t = _num(s.get("time"))
        age = now - t
        tier = None
        for i, (max_age, period) in enumerate(tiers):
            if age <= max_age:
                tier = (i, period)
                break
        if tier is None:
            continue  # past the last tier: dropped
        i, period = tier
        if period <= 0:
            kept.append(s)
            continue
        bucket = (i, int(t // period))
        if bucket in buckets_seen:
            continue
        buckets_seen[bucket] = 1
        kept.append(s)
    kept.reverse()
    return kept


# -- the writer --------------------------------------------------------------

class HistoryWriter:
    """Single-writer append + periodic compaction for one host's series.

    Attach it to a recorder (:meth:`attach`) and every heartbeat tick
    lands one sample; or drive :meth:`observe` directly with samples
    (tests, serve loops)."""

    def __init__(self, output_path: str, host_id: str,
                 clock=time.time) -> None:
        self.path = os.path.join(str(output_path),
                                 history_filename(host_id))
        self.host_id = str(host_id)
        self.clock = clock
        self._appends_since_compact = 0
        self._recorder = None
        # one failed append or compaction (ENOSPC) disables retention for
        # the run: the alert windows go quiet, the extraction goes on
        self._disabled = False

    def observe(self, sample: dict) -> None:
        if self._disabled:
            return
        try:
            jsonl.append_jsonl(self.path, sample)
            self._appends_since_compact += 1
            if self._appends_since_compact >= COMPACT_EVERY:
                self.compact()
        except OSError as e:
            self._disabled = True
            from . import inc
            inc("vft_telemetry_write_failures_total", pillar="history")
            print(f"telemetry: failed to append {self.path} "
                  f"({type(e).__name__}: {e}) — history retention "
                  "disabled for this run")

    def compact(self, now: Optional[float] = None) -> int:
        """Rewrite the file through :func:`downsample` (atomic temp +
        replace — the heartbeat's own discipline). Returns the retained
        sample count. Safe: this host is the file's only writer."""
        now = self.clock() if now is None else now
        samples = list(jsonl.read_jsonl(self.path))
        kept = downsample(samples, now=now)
        tmp = self.path + ".compact.tmp"
        try:
            # vft-lint: disable=VFT004 — temp+fsync+os.replace in place (line-oriented rewrite; jsonl.py appends records, it does not rewrite files)
            with open(tmp, "w", encoding="utf-8") as f:
                for s in kept:
                    f.write(json.dumps(s, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._appends_since_compact = 0
        return len(kept)

    # -- recorder hook ------------------------------------------------------
    def attach(self, recorder) -> "HistoryWriter":
        """Register on the recorder's tick hooks: every heartbeat write
        (including the first and the final one) appends one sample."""
        self._recorder = recorder
        recorder.tick_hooks.append(self._on_tick)
        return self

    def _on_tick(self, hb: dict) -> None:
        nonfinite = None
        r = self._recorder
        if r is not None:
            try:
                health = r.health_summary()
                nonfinite = sum(int(h.get("nan", 0)) + int(h.get("inf", 0))
                                for h in health.values())
            except Exception:
                nonfinite = None
        self.observe(sample_from_heartbeat(hb, nonfinite_total=nonfinite))


# -- readers -----------------------------------------------------------------

def read_history(root: str) -> Dict[str, List[dict]]:
    """Every host's retained series under ``root`` (recursively, like
    heartbeat collection): ``{host_id: [samples sorted by time]}``.
    The host id is read from the records themselves (filename sanitizing
    is lossy); files whose records carry none key by filename."""
    out: Dict[str, List[dict]] = {}
    for p in sorted(Path(str(root)).rglob(HISTORY_GLOB)):
        if "_incidents" in p.parts:
            continue  # bundle tails are frozen evidence, not live series
        fallback = p.name[len(HISTORY_PREFIX):-len(".jsonl")]
        for rec in jsonl.read_jsonl(p):
            if rec.get("schema") != SAMPLE_SCHEMA:
                continue
            host = str(rec.get("host_id") or fallback)
            out.setdefault(host, []).append(rec)
    for host in out:
        out[host].sort(key=lambda s: _num(s.get("time")))
    return out


def _field(sample: dict, path: str):
    cur: object = sample
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def latest(samples: Sequence[dict], path: str):
    """The newest sample's value at dotted ``path`` (None when the
    series is empty or the field is absent from the newest sample)."""
    if not samples:
        return None
    return _field(samples[-1], path)


def window_delta(samples: Sequence[dict], path: str, now: float,
                 window_s: float, allow_negative: bool = False
                 ) -> Optional[Tuple[float, float]]:
    """``(value_delta, span_s)`` of the value at dotted ``path`` over
    roughly the last ``window_s`` seconds: newest sample minus the
    newest sample at least ``window_s`` old. When the series is younger
    than the window the OLDEST sample is the baseline (a partial window
    — ``span_s`` tells the caller how partial), which is what makes
    short runs alertable at all. None when fewer than two samples carry
    the field — or, for cumulative counters (``allow_negative=False``,
    the default), when the counter reset (delta < 0: a new run reusing
    the dir — a window across runs is meaningless). Gauges that
    legitimately shrink (queue depth) pass ``allow_negative=True``."""
    series = [(_num(s.get("time")), _field(s, path)) for s in samples]
    series = [(t, _num(v)) for t, v in series if v is not None]
    if len(series) < 2:
        return None
    t_new, v_new = series[-1]
    baseline = series[0]
    cutoff = float(now) - float(window_s)
    for t, v in series:
        if t <= cutoff:
            baseline = (t, v)
        else:
            break
    t_old, v_old = baseline
    if t_new <= t_old:
        return None
    delta = v_new - v_old
    if delta < 0 and not allow_negative:
        return None
    return delta, t_new - t_old


def window_rate(samples: Sequence[dict], num_path: str, den_path: str,
                now: float, window_s: float
                ) -> Optional[Tuple[float, float, float]]:
    """``(numerator_delta, denominator_delta, ratio)`` of two cumulative
    counters over one shared window — the burn-rate primitive
    (violations over requests). None when either counter is unreadable
    or nothing happened in the window (denominator delta == 0)."""
    num = window_delta(samples, num_path, now, window_s)
    den = window_delta(samples, den_path, now, window_s)
    if num is None or den is None or den[0] <= 0:
        return None
    return num[0], den[0], num[0] / den[0]
