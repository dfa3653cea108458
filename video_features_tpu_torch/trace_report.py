"""Render a ``_trace.json`` host-pipeline timeline without Perfetto (port of
``scripts/trace_report.py``).

Companion to the ``trace=true`` CLI key (``telemetry/trace.py``): point it
at the run's output directory (or the ``_trace.json`` itself) and get

  - **per-thread utilization**: how busy each lane (bus decoder, family
    threads, prefetchers, video workers) was over the run;
  - **top stalls**: the longest backpressure waits
    (``fanout.put_blocked`` / ``fanout.get_starved`` /
    ``fanout.subscribe_wait`` / ``prefetch.put_blocked`` /
    ``retry_backoff`` / ``fleet.idle_wait``), each naming its family or
    video;
  - **per-video critical path**: decode vs transform vs H2D vs device vs
    write time inside each ``video_attempt`` window, with a ``*-bound``
    verdict per video and for the whole run.

Usage::

    python -m video_features_tpu_torch feature_type=... trace=true
    python -m video_features_tpu_torch.trace_report OUT [--top 10]
    python -m video_features_tpu_torch.trace_report OUT \\
        --merge CAPTURE [--out combined.json]

``--merge`` splices the host timeline with a ``torch.profiler`` capture
(``profile_trace_dir=``: the newest ``{host}_{pid}.{ms}.pt.trace.json``, or
``.gz``, under it, or that file itself) or with another run's
``_trace.json`` into ONE file Perfetto loads, host lanes and device lanes
side by side. When both inputs carry the wall-clock anchor the port's traces
stamp (``otherData.start_unix``, ``telemetry/trace.py``) the timelines land
on shared wall time; without both anchors (a ``torch.profiler`` capture has
none) both are rebased to start at 0 and the overlap is read structurally.
Whole-fleet stitching (N hosts' traces, lanes named by host) lives in
``python -m video_features_tpu_torch.fleet_report ROOT --stitch``.

Bucket heuristic for the verdict: ``forward`` spans are device time (under
async dispatch: device *stall* time), ``h2d`` spans the host->device
staging copy (``parallel/mesh.py``), ``write`` spans sink IO, and ``decode``
spans split by thread: on the shared-decode bus thread
(``vft-fanout-decode``) they are pure cv2 decode, on family, prefetch or
worker threads host transform work (in single-family runs decode and
transform conflated: the serial path times them as one stage).

A file torn by an abrupt exit fails with a clear message: the recorder
finalises through a temp file and ``os.replace``, so a half-written
``_trace.json`` means the run died before ``TraceRecorder.close()``.
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from .telemetry.trace import (STALL_SPAN_NAMES, TRACE_FILENAME,
                              TRACE_OUTPUT_NAMES)

#: decode-lane thread-name prefix (``parallel/fanout.py`` names its union
#: decoder thread this); splits "decode" into decode vs transform
DECODE_THREAD_NAME = "vft-fanout-decode"

#: report buckets: "h2d" is the host->device staging copy, "device" the
#: forward/materialisation stall, "write" sink IO
BUCKETS = ("decode", "transform", "h2d", "device", "write", "stall")

#: umbrella spans bracket a whole job INCLUDING its idle waits: they cut
#: windows (critical path) but do not count as busy time
UMBRELLA_SPAN_NAMES = ("family", "video_attempt", "fanout.decode_pass")

#: a ``utils/profiling.py TraceCapture`` file: {host}_{pid}.{ms}.pt.trace.json
_CAPTURE_RE = re.compile(r"\.(\d+)\.pt\.trace\.json(\.gz)?$")


def load_host_trace(path: str) -> Tuple[dict, str]:
    """Load ``_trace.json`` (or find it under an output dir), failing with
    an actionable message, never a JSON traceback, on a missing, truncated
    or non-trace file."""
    if os.path.isdir(path):
        cand = os.path.join(path, TRACE_FILENAME)
        if not os.path.exists(cand):
            # fleet workers and serve siblings co-owning this dir write
            # per-host _trace_{host_id}.json files instead: one is an
            # unambiguous input; several need the fleet stitcher
            others = sorted(
                p for p in glob.glob(os.path.join(path, "_trace*.json"))
                if os.path.basename(p) not in TRACE_OUTPUT_NAMES)
            if len(others) == 1:
                cand = others[0]
            elif len(others) > 1:
                raise SystemExit(
                    f"{path} holds {len(others)} per-host traces ("
                    + ", ".join(os.path.basename(p) for p in others)
                    + ") — pass one explicitly, or merge them all with "
                    "`python -m video_features_tpu_torch.fleet_report "
                    + path + " --stitch`")
        path = cand
    if not os.path.exists(path):
        raise SystemExit(f"no {TRACE_FILENAME} at {path} — was the run "
                         "launched with trace=true?")
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SystemExit(
            f"{path} is not a complete JSON trace ({e}). The recorder "
            "writes it atomically at close, so a torn file means the run "
            "died before TraceRecorder.close() (SIGKILL/OOM?) or the file "
            "was truncated afterwards — re-run with trace=true.") from None
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise SystemExit(f"{path} parsed as JSON but has no 'traceEvents' "
                         "array — not a Chrome trace-event file")
    return doc, path


def thread_names(events: List[dict]) -> Dict[int, str]:
    return {e.get("tid"): e.get("args", {}).get("name", "")
            for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}


def complete_events(events: List[dict]) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals: nested spans
    (a stage inside an attempt) must not count busy time twice."""
    if not intervals:
        return 0.0
    intervals.sort()
    total, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def utilization_table(xs: List[dict], names: Dict[int, str]) -> List[str]:
    if not xs:
        return ["(no complete events)"]
    t0 = min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in xs)
    wall = max(t1 - t0, 1e-9)
    by_tid: Dict[int, List[Tuple[float, float]]] = {}
    for e in xs:
        if e["name"] in UMBRELLA_SPAN_NAMES \
                or e["name"] in STALL_SPAN_NAMES:
            continue  # waits are not work
        by_tid.setdefault(e["tid"], []).append(
            (e["ts"], e["ts"] + e["dur"]))
    if not by_tid:
        return ["(only umbrella/stall spans present)"]
    lines = [f"timeline wall: {wall / 1e3:.1f} ms across "
             f"{len(by_tid)} threads",
             f"{'busy ms':>10}  {'util':>6}  thread"]
    rows = []
    for tid, iv in by_tid.items():
        busy = _union_us(iv)
        rows.append((busy, names.get(tid) or f"tid {tid}"))
    for busy, name in sorted(rows, reverse=True):
        lines.append(f"{busy / 1e3:10.1f}  {busy / wall * 100:5.1f}%  "
                     f"{name}")
    return lines


def top_stalls(xs: List[dict], top: int) -> List[str]:
    stalls = [e for e in xs if e["name"] in STALL_SPAN_NAMES]
    if not stalls:
        return ["(no stalls past the 1 ms trace threshold — the pipeline "
                "never waited on itself)"]
    total_by_name: Dict[str, float] = {}
    for e in stalls:
        total_by_name[e["name"]] = total_by_name.get(e["name"], 0) + e["dur"]
    lines = ["totals: " + ", ".join(
        f"{n} {v / 1e3:.1f} ms" for n, v in
        sorted(total_by_name.items(), key=lambda kv: -kv[1]))]
    lines.append(f"{'ms':>9}  stall")
    for e in sorted(stalls, key=lambda e: -e["dur"])[:top]:
        args = e.get("args", {})
        tag = args.get("family") or os.path.basename(
            str(args.get("video", "")))
        lines.append(f"{e['dur'] / 1e3:9.1f}  {e['name']}"
                     + (f" [{tag}]" if tag else ""))
    return lines


def _overlap(e: dict, w0: float, w1: float) -> float:
    return max(0.0, min(e["ts"] + e["dur"], w1) - max(e["ts"], w0))


def bucket_of(e: dict, names: Dict[int, str],
              has_bus: bool) -> Optional[str]:
    n = e["name"]
    if n == "forward":
        return "device"
    if n == "h2d":
        return "h2d"
    if n == "write":
        return "write"
    if n in STALL_SPAN_NAMES:
        return "stall"
    if n == "decode":
        if not has_bus:
            return "decode"  # serial path: decode+transform as one stage
        tname = names.get(e["tid"], "")
        return "decode" if tname.startswith(DECODE_THREAD_NAME) \
            else "transform"
    return None


def critical_path(xs: List[dict], names: Dict[int, str],
                  ) -> Tuple[List[str], Dict[str, float]]:
    """Per-video decode/transform/h2d/device/write split inside each
    video's ``video_attempt`` windows, plus run-wide bucket totals (µs)."""
    attempts = [e for e in xs if e["name"] == "video_attempt"]
    has_bus = any(str(n).startswith(DECODE_THREAD_NAME)
                  for n in names.values())
    totals = {b: 0.0 for b in BUCKETS}
    if not attempts:
        return (["(no video_attempt spans — nothing ran, or the trace "
                 "predates this instrumentation)"], totals)
    windows: Dict[str, List[Tuple[float, float]]] = {}
    for e in attempts:
        video = str(e.get("args", {}).get("video", "?"))
        windows.setdefault(video, []).append((e["ts"], e["ts"] + e["dur"]))
    lines = [f"{'video':<40} {'wall ms':>9}  "
             + "  ".join(f"{b[:9]:>9}" for b in BUCKETS) + "  verdict"]
    stage_events = [e for e in xs if bucket_of(e, names, has_bus)]
    for video, ws in sorted(windows.items()):
        per = {b: 0.0 for b in BUCKETS}
        for e in stage_events:
            b = bucket_of(e, names, has_bus)
            ov = sum(_overlap(e, w0, w1) for w0, w1 in ws)
            if ov > 0:
                per[b] += ov
        for b in BUCKETS:
            totals[b] += per[b]
        wall = sum(w1 - w0 for w0, w1 in ws)
        verdict = max(per, key=per.get) if any(per.values()) else "?"
        lines.append(
            f"{os.path.basename(video)[:40]:<40} {wall / 1e3:9.1f}  "
            + "  ".join(f"{per[b] / 1e3:9.1f}" for b in BUCKETS)
            + f"  {verdict}-bound")
    return lines, totals


def stage_summary(path: str) -> dict:
    """Run-wide per-stage totals of a trace artifact: ``{bucket}_ms``, plus
    the bottleneck verdict (``None`` when nothing was attributed). The
    programmatic face of this report."""
    doc, _ = load_host_trace(path)
    events = doc["traceEvents"]
    names = thread_names(events)
    xs = complete_events(events)
    _, totals = critical_path(xs, names)
    busy = {b: v for b, v in totals.items() if b != "stall"}
    verdict = max(busy, key=busy.get) if any(busy.values()) else None
    out = {f"{b}_ms": round(v / 1e3, 1) for b, v in totals.items()}
    out["verdict"] = f"{verdict}-bound" if verdict else None
    return out


def merge_traces(host: dict, device: dict) -> dict:
    """One Perfetto-loadable file: the device trace plus the host lanes
    under a pid above every integer pid of the device trace.

    **Clock alignment**: when BOTH inputs carry a wall-clock anchor
    (``otherData.start_unix``, stamped at recorder start), each timeline
    keeps its internal ``ts`` and shifts by ``anchor - min(anchors)``, so
    two captures not started together stay honestly offset. Without both
    anchors (a ``torch.profiler`` capture has none) both are rebased to
    t=0 and the overlap is read structurally. A capture's string lanes
    (``"stream 7"`` tids, the ``"Traces"`` pid) and metadata events pass
    through unchanged."""

    def _anchor(doc: dict):
        a = (doc.get("otherData") or {}).get("start_unix")
        return float(a) if isinstance(a, (int, float)) else None

    dev_events = [dict(e) for e in device.get("traceEvents", [])
                  if isinstance(e, dict)]
    host_events = [dict(e) for e in host.get("traceEvents", [])
                   if isinstance(e, dict)]

    def rebase(events: List[dict], shift: Optional[float] = None) -> None:
        """shift=None: rebase min ts to 0; else add ``shift`` µs."""
        stamped = [e["ts"] for e in events
                   if isinstance(e.get("ts"), (int, float))]
        if not stamped:
            return
        delta = -min(stamped) if shift is None else shift
        for e in events:
            if isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] + delta

    ha, da = _anchor(host), _anchor(device)
    if ha is not None and da is not None:
        t0 = min(ha, da)
        rebase(host_events, shift=(ha - t0) * 1e6)
        rebase(dev_events, shift=(da - t0) * 1e6)
        how = ("wall-clock aligned on otherData.start_unix anchors "
               f"(earliest {t0})")
    else:
        rebase(dev_events)
        rebase(host_events)
        how = ("both rebased to t=0 (no shared wall-clock anchor; vft "
               "traces carry otherData.start_unix, this capture did not)")
    dev_pids = [e.get("pid") for e in dev_events
                if isinstance(e.get("pid"), int)]
    host_pid = (max(dev_pids) if dev_pids else 0) + 100000
    for e in host_events:
        e["pid"] = host_pid
    return {"traceEvents": dev_events + host_events,
            "displayTimeUnit": "ms",
            "otherData": {"merged": "vft host trace + device/second "
                                    "trace: " + how,
                          "aligned": ha is not None and da is not None}}


def _capture_key(path: str) -> Tuple[int, float]:
    """Newest first by the capture's millisecond stamp, then mtime."""
    m = _CAPTURE_RE.search(os.path.basename(path))
    return (int(m.group(1)) if m else -1, os.path.getmtime(path))


def load_profile_capture(path: str) -> dict:
    """A ``torch.profiler`` Chrome trace: ``path`` itself, or the newest
    ``*.pt.trace.json`` (or ``.gz``) under the ``profile_trace_dir``
    ``path``. Several processes' captures in one dir: the newest is read
    and the rest named on stderr, never silently merged."""
    if os.path.isdir(path):
        hits = [h for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
                for h in glob.glob(os.path.join(path, "**", pat),
                                   recursive=True)]
        if not hits:
            raise SystemExit(
                f"no *.pt.trace.json[.gz] under {path} — was it captured "
                "with profile_trace_dir=?")
        hits.sort(key=_capture_key)
        if len(hits) > 1:
            print(f"NOTE: {len(hits)} captures under {path}; merging the "
                  f"newest, {os.path.basename(hits[-1])}", file=sys.stderr)
        path = hits[-1]
    elif not os.path.exists(path):
        raise SystemExit(f"no {TRACE_FILENAME} and no capture at {path} "
                         "— was it captured with profile_trace_dir=?")
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, EOFError,
            OSError) as e:
        raise SystemExit(f"{path} is not a complete trace capture "
                         f"({e})") from None
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise SystemExit(f"{path} has no 'traceEvents' array — not a "
                         "Chrome trace-event file")
    return doc


def _load_device_trace(trace_path: str) -> dict:
    """The ``--merge`` target: a port ``_trace.json`` (the file, or a run
    dir holding one: two host traces align on their anchors), else a
    ``torch.profiler`` capture (:func:`load_profile_capture`)."""
    cand = (os.path.join(trace_path, TRACE_FILENAME)
            if os.path.isdir(trace_path) else trace_path)
    if os.path.basename(cand) == TRACE_FILENAME and os.path.exists(cand):
        doc, _ = load_host_trace(cand)
        return doc
    return load_profile_capture(trace_path)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="host-pipeline timeline report for a trace=true run")
    ap.add_argument("path", help="run output dir or _trace.json path")
    ap.add_argument("--top", type=int, default=10,
                    help="stalls to list (default 10)")
    ap.add_argument("--merge", metavar="CAPTURE", default=None,
                    help="also merge with a torch.profiler capture "
                         "(profile_trace_dir=, or one .pt.trace.json) — or "
                         "another run's _trace.json, wall-clock aligned — "
                         "into one Perfetto file")
    ap.add_argument("--out", default=None,
                    help="merged-trace output path (default: "
                         "_trace_merged.json next to the input)")
    args = ap.parse_args(argv)

    doc, path = load_host_trace(args.path)
    events = doc["traceEvents"]
    names = thread_names(events)
    xs = complete_events(events)
    other = doc.get("otherData", {})
    dropped = other.get("dropped_events", 0)
    print(f"{path}: {len(xs)} spans, {len(names)} threads"
          + (f", {dropped} DROPPED (per-thread cap hit)" if dropped else ""))

    print("\n== per-thread utilization ==")
    for line in utilization_table(xs, names):
        print(line)

    print("\n== top stalls ==")
    for line in top_stalls(xs, args.top):
        print(line)

    print("\n== per-video critical path ==")
    lines, totals = critical_path(xs, names)
    for line in lines:
        print(line)
    busy = {b: v for b, v in totals.items() if b != "stall"}
    if any(busy.values()):
        bottleneck = max(busy, key=busy.get)
        total = sum(busy.values())
        print(f"\nverdict: {bottleneck}-bound "
              f"({busy[bottleneck] / total * 100:.0f}% of attributed busy "
              "time" + (f"; + {totals['stall'] / 1e3:.1f} ms recorded "
                        "stalls" if totals["stall"] else "") + ")")

    if args.merge:
        merged = merge_traces(doc, _load_device_trace(args.merge))
        out = args.out or os.path.join(os.path.dirname(path),
                                       "_trace_merged.json")
        from .utils.sinks import _write_bytes_atomic
        _write_bytes_atomic(out, json.dumps(merged).encode())
        print(f"\nmerged host+device trace: {out} "
              f"({len(merged['traceEvents'])} events) — open in "
              "https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
