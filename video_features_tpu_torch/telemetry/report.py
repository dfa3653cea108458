"""The per-run report: a run's telemetry artifacts rendered for an operator
(the port of the JAX package's per-run telemetry report).

    python -m video_features_tpu_torch.telemetry.report OUT_DIR
    python -m video_features_tpu_torch.telemetry.report OUT_DIR --prom FILE
    python -m video_features_tpu_torch.telemetry.report OUT_DIR --slowest 10

It reads the output dir of a ``telemetry=true`` run (or of several hosts
sharing it): ``_run.json`` (the manifest), ``_heartbeat_{host_id}.json``,
``_telemetry.jsonl`` (one span per video), ``_failures.jsonl`` (the fault
journal) and ``_alerts.jsonl`` (``alerts=true``), and prints whether every
host is alive, what each works on, where the time went, which videos were
slow or failed, and which alerts are pending or firing. Everything comes
from the artifacts, so it works on a dead run too; the formats are the JAX
package's, so it reads either package's runs. The manifest header names
torch, CUDA and the card where the JAX report names jax.

``--prom`` writes the manifest's metrics dump as a Prometheus textfile;
``--fail-on-failures``, ``--fail-on-slo`` and ``--fail-on-alert`` exit 1
on a terminal failure in the journal, an SLO violation in a serving
heartbeat, or a firing alert.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..fleet_report import _fmt_age, _load_json, fleet_stragglers
from .alerts import current_alerts, render_alerts
from .heartbeat import HEARTBEAT_GLOB, STALL_INTERVALS, matches_run
from .jsonl import read_jsonl
from .manifest import MANIFEST_FILENAME
from .metrics import prometheus_text

SPANS_FILENAME = "_telemetry.jsonl"
FAILURES_FILENAME = "_failures.jsonl"


def render_manifest(man: dict) -> List[str]:
    lines = ["== run manifest (_run.json) =="]
    topo = man.get("topology", {})
    lines.append(
        f"  feature_type={man.get('feature_type')}  host={man.get('host')}"
        f"  run_id={man.get('run_id')}"
        f"  wall={man.get('wall_s')}s  videos/s={man.get('videos_per_s')}")
    lines.append(
        f"  git={str(man.get('git', {}).get('commit'))[:12]}"
        f"{' (dirty)' if man.get('git', {}).get('dirty') else ''}"
        f"  torch={man.get('versions', {}).get('torch')}"
        f"  cuda={man.get('versions', {}).get('torch_cuda')}"
        f"  device={topo.get('device_name')}"
        f"  platform={topo.get('platform')}"
        f"  devices={topo.get('n_local_devices')}/"
        f"{topo.get('n_global_devices')}"
        f"  process={topo.get('process_index')}/"
        f"{topo.get('process_count')}")
    if man.get("tally"):
        lines.append("  tally: " + ", ".join(
            f"{k}={v}" for k, v in sorted(man["tally"].items())))
    cc = man.get("compile_cache", {})
    if cc:
        lines.append(f"  compile cache: {cc.get('hits', 0)} hits / "
                     f"{cc.get('misses', 0)} misses")
    for fam, h in sorted((man.get("health") or {}).items()):
        bad = h.get("nonfinite_records", 0)
        lines.append(
            f"  health[{fam}]: {h.get('records', 0)} digests, "
            f"{h.get('nan', 0)} NaN / {h.get('inf', 0)} Inf"
            + (f"  ({bad} NON-FINITE record(s))" if bad else ""))
    for fam, f in sorted(((man.get("roofline") or {})
                          .get("families") or {}).items()):
        mfu = f.get("mfu")
        verdict = f.get("verdict")
        lines.append(
            f"  roofline[{fam}]: "
            + (f"mfu={100 * mfu:.1f}%" if mfu is not None else "mfu=?")
            + (f"  eff={f.get('effective_tflops')} TFLOPS"
               if f.get("effective_tflops") is not None else "")
            + f"  {'host-bound (sandbagged)' if verdict == 'host-bound' else verdict or '?'}")
    totals = man.get("stage_totals", {})
    if totals:
        acc = sum(v.get("s", 0.0) for v in totals.values()) or 1.0
        lines.append("  stage totals (can overlap wall clock):")
        for name, v in sorted(totals.items(), key=lambda kv: -kv[1]["s"]):
            s, calls = v.get("s", 0.0), v.get("calls", 0)
            lines.append(
                f"    {name:<10} {s:9.3f}s {100 * s / acc:5.1f}%  "
                f"{calls:7d} calls  {1e3 * s / max(calls, 1):8.3f} ms/call")
    return lines


def _render_serve(hb: dict) -> List[str]:
    """The per-host ``serve:`` line(s): state/queue plus the SLO block
    (attainment %, p50/p95/p99 of the queue-wait and service splits,
    violation count) the serve heartbeat section publishes."""
    serve = hb.get("serve")
    if not isinstance(serve, dict):
        return []
    line = (f"    serve: {serve.get('state')}  "
            f"pending={serve.get('pending', 0)} "
            f"inflight={serve.get('inflight', 0)}  requests: "
            + ", ".join(f"{k}={v}" for k, v in
                        sorted((serve.get("requests") or {}).items())))
    lines = [line]
    slo = serve.get("slo")
    if isinstance(slo, dict) and slo.get("requests"):
        svc = slo.get("service") or {}
        qw = slo.get("queue_wait") or {}
        sl = (f"    slo: service p50/p95/p99="
              f"{svc.get('p50')}/{svc.get('p95')}/{svc.get('p99')}s  "
              f"wait p50/p95/p99="
              f"{qw.get('p50')}/{qw.get('p95')}/{qw.get('p99')}s")
        if slo.get("slo_s") is not None:
            sl += (f"  objective={slo['slo_s']}s "
                   f"violations={slo.get('violations', 0)} "
                   f"attainment={slo.get('attainment_pct')}%")
        lines.append(sl)
    return lines


def render_heartbeats(paths: List[str], now: float,
                      run_id: Optional[str] = None,
                      started_time: Optional[float] = None) -> List[str]:
    lines = ["== heartbeats =="]
    if not paths:
        return lines + ["  (none)"]
    loaded = {p: _load_json(p) for p in sorted(paths)}
    stragglers = fleet_stragglers(
        [hb for hb in loaded.values() if hb is not None], now)
    for p in sorted(paths):
        hb = loaded[p]
        if hb is None:
            lines.append(f"  {os.path.basename(p)}: unreadable")
            continue
        if not matches_run(hb, run_id, started_time):
            # a prior run of the same output_path left this file behind;
            # counting it would invent a stalled/dead worker (or sum a
            # dead run's stage deltas into this one)
            lines.append(f"  {hb.get('host_id')}: PRIOR RUN (run_id="
                         f"{hb.get('run_id')}) — ignored")
            continue
        age = max(0.0, now - float(hb.get("time", now)))
        interval = float(hb.get("interval_s", 30.0)) or 30.0
        if hb.get("final"):
            state = "FINISHED"
        elif age > STALL_INTERVALS * interval:
            state = "STALLED?"
        else:
            state = "alive"
        lines.append(
            f"  {hb.get('host_id')}: {state}  age={_fmt_age(age)}  "
            f"done={hb.get('videos_done', 0)}  "
            f"videos/s={hb.get('videos_per_s')}  "
            f"last={hb.get('last_video')}")
        delta = hb.get("stage_delta") or {}
        if delta and not hb.get("final"):
            lines.append("    last interval: " + ", ".join(
                f"{k}={v.get('s', 0):.2f}s/{v.get('calls', 0)}c"
                for k, v in sorted(delta.items())))
        # why work was avoided (cache.py): hits consulted the store and
        # matched; bypasses are the filename skip-if-exists check (which
        # runs with cache=false too); a cache hit takes precedence
        ca = hb.get("cache") or {}
        tallies = [(k, sum((ca.get(k) or {}).values()))
                   for k in ("hits", "misses", "bypasses")]
        if any(n for _, n in tallies):
            rate = ca.get("hit_rate")
            lines.append("    cache: " + ", ".join(
                f"{k}={n}" for k, n in tallies)
                + (f", hit_rate={rate}" if rate is not None else ""))
        # fleet=queue scheduling state (the fleet queue): which host is
        # doing/stealing the work, and — via the straggler flag — which
        # one the rest of the fleet is idling behind, without opening a
        # trace
        # roofline accounting (telemetry/roofline.py): per-family MFU %
        # and the saturated-vs-sandbagged verdict, right next to the
        # cache/fleet/slo lines — absent when roofline=false
        rf = hb.get("roofline") or {}
        if isinstance(rf, dict) and rf.get("families"):
            parts = []
            for fam, f in sorted(rf["families"].items()):
                mfu = f.get("mfu")
                eff = f.get("effective_tflops")
                verdict = f.get("verdict")
                if verdict == "host-bound":
                    verdict = "host-bound (sandbagged)"
                parts.append(
                    f"{fam} mfu="
                    + (f"{100 * mfu:.1f}%" if mfu is not None else "?")
                    + (f" ({eff} TF)" if eff is not None else "")
                    + f" {verdict or '?'}")
            lines.append("    roofline: " + "; ".join(parts))
        fl = hb.get("fleet")
        if isinstance(fl, dict):
            q = fl.get("queue") or {}
            line = ("    fleet: "
                    f"claimed={fl.get('claimed', 0)} "
                    f"done={fl.get('done', 0)} "
                    f"stolen={fl.get('stolen', 0)} "
                    f"reclaimed={fl.get('reclaimed', 0)} "
                    f"active={fl.get('active_claims', 0)} "
                    f"(oldest {fl.get('oldest_active_claim_age_s', 0):.0f}s)"
                    f"  queue: pending={q.get('pending', 0)}/"
                    f"claimed={q.get('claimed', 0)}/done={q.get('done', 0)}"
                    + (f"/quarantined={q['quarantined']}"
                       if q.get("quarantined") else "")
                    + (f"  canary={fl['canary']}"
                       if fl.get("canary") not in (None, "off") else ""))
            if str(hb.get("host_id")) in stragglers:
                line += "  STRAGGLER (fleet idle behind this host)"
            lines.append(line)
        lines += _render_serve(hb)
    return lines


def slo_violation_tallies(paths: List[str], run_id: Optional[str] = None,
                          started_time: Optional[float] = None
                          ) -> Dict[str, int]:
    """``{host_id: violations}`` over the current run's serve heartbeats
    — the ``--fail-on-slo`` gate's input (prior-run files excluded, like
    the rendering)."""
    out: Dict[str, int] = {}
    for p in paths:
        hb = _load_json(p)
        if hb is None or not matches_run(hb, run_id, started_time):
            continue
        slo = (hb.get("serve") or {}).get("slo") \
            if isinstance(hb.get("serve"), dict) else None
        if isinstance(slo, dict) and int(slo.get("violations") or 0):
            out[str(hb.get("host_id"))] = int(slo["violations"])
    return out


def render_spans(spans: List[dict], slowest: int) -> List[str]:
    lines = [f"== per-video spans ({SPANS_FILENAME}: {len(spans)} records) =="]
    if not spans:
        return lines + ["  (none)"]
    by_status: Dict[str, int] = {}
    retries = 0
    for s in spans:
        by_status[s.get("status", "?")] = \
            by_status.get(s.get("status", "?"), 0) + 1
        retries += max(0, int(s.get("attempts", 1) or 1) - 1)
    lines.append("  status: " + ", ".join(
        f"{k}={v}" for k, v in sorted(by_status.items()))
        + f"; extra attempts={retries}")
    ranked = sorted(spans, key=lambda s: -(s.get("wall_s") or 0.0))
    lines.append(f"  slowest {min(slowest, len(ranked))}:")
    for s in ranked[:slowest]:
        stages = s.get("stages") or {}
        split = " ".join(f"{k}={v.get('s', 0):.2f}s"
                        for k, v in sorted(stages.items()))
        lines.append(
            f"    {s.get('wall_s', 0):8.2f}s  {s.get('status', '?'):<11} "
            f"{s.get('video')}  [{split}]")
    errors = [s for s in ranked if s.get("status") == "error"]
    if errors:
        lines.append("  failures:")
        for s in errors[:slowest]:
            lines.append(f"    {s.get('video')}: {s.get('category')} "
                         f"after {s.get('attempts')} attempt(s): "
                         f"{str(s.get('error'))[:120]}")
    return lines


def render_failures(path: str) -> Tuple[List[str], Dict[str, int]]:
    """(report lines, gating tallies). Gating uses the journal's
    last-record-wins-per-video contract (utils/faults.py): a video whose
    quarantine was later RESOLVED does not count against
    ``--fail-on-failures``."""
    latest: Dict[str, str] = {}
    for rec in read_jsonl(path):
        latest[str(rec.get("video"))] = rec.get("category", "?")
    tallies: Dict[str, int] = {}
    for cat in latest.values():
        tallies[cat] = tallies.get(cat, 0) + 1
    resolved = tallies.pop("RESOLVED", 0)
    if not tallies and not resolved:
        return [], tallies
    line = "  " + ", ".join(f"{k}={v}" for k, v in sorted(tallies.items()))
    if resolved:
        line += f"{', ' if tallies else ''}RESOLVED={resolved}"
    return ["== fault journal (_failures.jsonl) ==", line], tallies


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("output_dir", help="a telemetry=true run's output_path")
    ap.add_argument("--prom", metavar="FILE", default=None,
                    help="also write a Prometheus textfile export of the "
                         "manifest's metrics dump")
    ap.add_argument("--slowest", type=int, default=5,
                    help="how many slowest/failed videos to list")
    ap.add_argument("--fail-on-failures", action="store_true",
                    help="exit 1 when _failures.jsonl holds any terminal "
                         "failure — lets shell pipelines gate on run "
                         "health (extract ... && python -m "
                         "video_features_tpu_torch.telemetry.report OUT "
                         "--fail-on-failures && deploy)")
    ap.add_argument("--fail-on-slo", action="store_true",
                    help="exit 1 when any current-run serving heartbeat "
                         "reports SLO violations (serve_slo_s=) — the "
                         "CI/canary gate on serving latency")
    ap.add_argument("--fail-on-alert", action="store_true",
                    help="exit 1 while any alert episode in "
                         "_alerts.jsonl is firing (prior-run excluded; "
                         "alerts=true, telemetry/alerts.py) — gate shell "
                         "pipelines on the run watching itself")
    args = ap.parse_args(argv)
    out = args.output_dir
    if not os.path.isdir(out):
        print(f"error: {out} is not a directory", file=sys.stderr)
        return 2

    now = time.time()
    lines: List[str] = [f"telemetry report: {out}"]
    man = _load_json(os.path.join(out, MANIFEST_FILENAME))
    if man is not None:
        lines += render_manifest(man)
    else:
        lines += ["== run manifest (_run.json) ==",
                  "  absent (run still in flight, or telemetry=false)"]
    hb_paths = glob.glob(os.path.join(out, HEARTBEAT_GLOB))
    lines += render_heartbeats(
        hb_paths, now,
        run_id=(man or {}).get("run_id"),
        started_time=(man or {}).get("started_time"))
    spans = list(read_jsonl(os.path.join(out, SPANS_FILENAME)))
    lines += render_spans(spans, args.slowest)
    failure_lines, failure_tallies = render_failures(
        os.path.join(out, FAILURES_FILENAME))
    lines += failure_lines
    # active alert episodes (alerts=true, telemetry/alerts.py):
    # last-record-wins off _alerts.jsonl, prior-run excluded like the
    # heartbeats above
    active_alerts = current_alerts(
        out, started_time=(man or {}).get("started_time"))
    lines += render_alerts(active_alerts)
    print("\n".join(lines))

    if args.prom:
        dump = (man or {}).get("metrics", {"series": []})
        # atomic: a textfile collector may read the file at any moment
        from ..utils.sinks import _write_bytes_atomic
        _write_bytes_atomic(args.prom, prometheus_text(dump).encode())
        print(f"prometheus textfile: {args.prom} "
              f"({len(dump.get('series', []))} series)")
    if args.fail_on_failures and failure_tallies:
        n = sum(failure_tallies.values())
        print(f"fail-on-failures: {n} journal record(s) "
              f"({', '.join(f'{k}={v}' for k, v in sorted(failure_tallies.items()))})",
              file=sys.stderr)
        return 1
    if args.fail_on_slo:
        slo_bad = slo_violation_tallies(
            hb_paths, run_id=(man or {}).get("run_id"),
            started_time=(man or {}).get("started_time"))
        if slo_bad:
            print("fail-on-slo: "
                  + ", ".join(f"{h}: {v} violation(s)"
                              for h, v in sorted(slo_bad.items())),
                  file=sys.stderr)
            return 1
    if args.fail_on_alert:
        firing = [a for a in active_alerts if a.get("state") == "firing"]
        if firing:
            print("fail-on-alert: "
                  + ", ".join(f"{a['rule']}({a['scope']}): {a['summary']}"
                              for a in firing), file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
