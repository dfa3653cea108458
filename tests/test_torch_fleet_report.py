"""The port's fleet report against the JAX package's.

Every case writes one synthetic tree of artifacts (heartbeats, manifests,
queue dirs, spans, traces, history, rooflines, verdicts, alert journals)
from a fixed ``NOW`` and a numpy seed, after ``tests/test_fleet_report.py``,
and runs the JAX function and the port's on it. The tolerance is exact:
``aggregate``'s dict, ``render``'s lines, ``build_prom_dump``'s series and
their ``prometheus_text``, the stitched trace, the request lookup and the
capacity planner's recommendations are equal. The rendered lines differ in
one place only, by design: where a line names the tool that shows more,
each package names its own (:data:`TOOLS`).

Held besides: the port's ``find_trace_files`` skips the stitched outputs
(``telemetry/trace.py TRACE_OUTPUT_NAMES``); a planner's state file and the
retained history written by one package are read by the other's planner;
``main`` gives the same output and exit codes, and its textfile parses.
"""
import copy
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu import fleet_report as jfleet
from video_features_tpu.telemetry import history as jhistory
from video_features_tpu.telemetry import metrics as jmetrics
from video_features_tpu.telemetry import parity as jparity
from video_features_tpu.telemetry.jsonl import write_json_atomic
from video_features_tpu_torch import fleet_report as tfleet
from video_features_tpu_torch.telemetry import alerts as talerts
from video_features_tpu_torch.telemetry import history as thistory
from video_features_tpu_torch.telemetry import metrics as tmetrics
from video_features_tpu_torch.telemetry import trace as ttrace

NOW = 1_700_000_000.0
#: the port's pointer to its own tool -> the JAX package's, in render()
TOOLS = {
    "(python -m video_features_tpu_torch.telemetry.roofline for the full "
    "table)": "(vft-roofline for the full table)",
    "(python -m video_features_tpu_torch parity for the full table)":
        "(vft-parity for the full table)",
    "(the gc report: ROADMAP.md Queue 1 #8)": "(vft-gc for the full report)",
}
PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.e+-]+$')


def _jax_names(lines):
    out = []
    for line in lines:
        for port, jax in TOOLS.items():
            line = line.replace(port, jax)
        out.append(line)
    return out


def _hb(host_id, t, *, final=False, interval=30.0, run_id="run-a", done=3,
        **sections):
    hb = {"schema": "vft.heartbeat/1", "run_id": run_id, "host": "synth",
          "host_id": host_id, "pid": 1, "feature_type": "resnet", "time": t,
          "started_time": t - 60, "uptime_s": 60.0, "interval_s": interval,
          "final": final, "videos": {"done": done}, "videos_done": done,
          "videos_per_s": 0.5, "last_video": "x.mp4"}
    hb.update(sections)
    return hb


def _write_hb(d: Path, hb: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    write_json_atomic(d / f"_heartbeat_{hb['host_id']}.json", hb)


def _slo(rng, n):
    v = int(rng.integers(0, n // 4 + 1))
    q = {p: round(float(x), 3) for p, x in
         zip(("p50", "p95", "p99"), np.sort(rng.uniform(0, 3, 3)))}
    return {"slo_s": 2.0, "requests": n, "violations": v,
            "attainment_pct": round(100.0 * (n - v) / n, 2),
            "queue_wait": q, "service": dict(q)}


# -- the trees (one per JAX test of the same name) ---------------------------

def tree_classify(root: Path, rng) -> None:
    _write_hb(root, _hb("live-1", NOW - 5))
    _write_hb(root, _hb("stale-1", NOW - 200))
    _write_hb(root, _hb("done-1", NOW - 400, final=True))
    _write_hb(root, _hb("prior-1", NOW - 500, run_id="old-run"))
    (root / "_heartbeat_torn.json").write_text("{not json")
    write_json_atomic(root / "_run.json",
                      {"run_id": "run-a", "started_time": NOW - 100})


def tree_straggler_and_queue(root: Path, rng) -> None:
    q = {"pending": 0, "claimed": 1, "done": int(rng.integers(1, 9))}
    _write_hb(root, _hb("busy-1", NOW - 2, fleet={
        "mode": "queue", "active_claims": 1, "queue": q, "claimed": 4,
        "done": 3, "stolen": 1, "reclaimed": 0,
        "idle_wait_s_total": 1.5}))
    _write_hb(root, _hb("idle-1", NOW - 2, fleet={
        "mode": "queue", "active_claims": 0, "queue": q, "claimed": 2,
        "done": 2, "stolen": 0, "reclaimed": 0,
        "idle_wait_s_total": 40.0}))
    for d, n in (("pending", int(rng.integers(0, 4))), ("done", 1)):
        dd = root / "_queue" / d
        dd.mkdir(parents=True)
        for i in range(n):
            (dd / f"it{i}.json").write_text("{}")
    (root / "_queue" / "claimed" / "busy-1").mkdir(parents=True)
    (root / "_queue" / "claimed" / "busy-1" / "it9.json").write_text("{}")


def tree_serve_tenants_and_cache(root: Path, rng) -> None:
    for i, host in enumerate(("srv-1", "srv-2")):
        n = int(rng.integers(10, 100))
        serve = {"state": "ready", "pending": i, "inflight": 1 - i,
                 "requests": {"done": n}, "active_requests": ["r1"][:1 - i],
                 "slo": _slo(rng, n),
                 "tenants": {"alpha": {"requests": n, "violations": i,
                                       "rejects": 0},
                             "beta": {"requests": 10, "violations": 2,
                                      "rejects": 4}}}
        _write_hb(root, _hb(host, NOW - 2, serve=serve, cache={
            "hits": {"resnet": int(rng.integers(0, 30)), "clip": 5},
            "misses": {"resnet": int(rng.integers(0, 30))},
            "bypasses": {"resnet": 2}, "hit_rate": 0.5}))
    gw = _hb("gw-1", NOW - 2, gateway={
        "state": "ready", "queued_total": 0,
        "tenants": {"beta": {"accepted": 10, "rejected": 5, "shed": 2}}})
    _write_hb(root, gw)


def tree_compile_cache_and_gc(root: Path, rng) -> None:
    _write_hb(root, _hb("warm-1", NOW - 2, compile_cache={
        "hits": 4, "misses": 0, "entry": "abc123def456", "family": "resnet",
        "warm_at_attach": True, "verified": 4, "dropped": 0},
        gc={"used_bytes": 9 * 10**10, "quota_bytes": 10**11,
            "planes": {"cache": 6 * 10**10, "spool": 3 * 10**10},
            "tenants": {"alpha": 10**9}}))
    _write_hb(root, _hb("cold-1", NOW - 3, compile_cache={
        "hits": 0, "misses": 3, "entry": "abc123def456", "family": "resnet",
        "warm_at_attach": False, "verified": 0, "dropped": 1}))


def tree_port_observatories(root: Path, rng) -> None:
    """What the port writes: two hosts' i3d runs with spans, rooflines,
    a certify verdict that drifted, history, alerts and a scenario."""
    for h in range(2):
        d = root / f"host{h}" / "i3d"
        _write_hb(d, _hb(f"p0-host{h}", NOW - 1 - h, final=True,
                         feature_type="i3d"))
        with open(d / "_telemetry.jsonl", "w") as f:
            for i in range(int(rng.integers(1, 4))):
                f.write(json.dumps({
                    "video": f"v{i}.mp4", "feature_type": "i3d",
                    "status": ["done", "error"][int(i == 2)],
                    "wall_s": float(rng.uniform(1, 3))}) + "\n")
        write_json_atomic(d / "_roofline.json", {
            "schema": "vft.roofline/1", "time": NOW,
            "device": {"device_kind": "NVIDIA H100 80GB HBM3",
                       "platform": "gpu", "peak_tflops": 773.7,
                       "peak_gbps": 3065.0, "source": "registry"},
            "families": {"i3d": {
                "flops_total": 2.4e13, "bytes_total": 4.5e11,
                "dispatches": 1, "forward_s": float(rng.uniform(1.4, 1.8)),
                "h2d_s": 0.01, "wall_s": 2.2}}})
        with open(d / "_history_p0-host{}.jsonl".format(h), "w") as f:
            for k in range(3):
                f.write(json.dumps({
                    "schema": jhistory.SAMPLE_SCHEMA, "host_id": f"p0-host{h}",
                    "time": NOW - 10 + k, "uptime_s": k,
                    "slo": {"requests": 10 * k, "violations": k}}) + "\n")
    seams = {s: {"pairs": 2, "mean_abs": 0.0, "max_rel": 0.0,
                 "max_abs": 9.0 if s == "head" else 0.0,
                 "cos": 0.5 if s == "head" else 1.0, "tol_max_abs": 0.5,
                 "tol_cos": 0.99, "why": "w", "ok": s != "head",
                 "note": None} for s in jparity.SEAMS}
    write_json_atomic(root / "host0" / "_parity_verdict.json", {
        "schema": jparity.VERDICT_SCHEMA, "family": "raft", "host": "vm",
        "flip": "dtype=bf16", "seams": seams, "first_drift": "head",
        "verdict": "FAIL", "time": NOW})
    write_json_atomic(root / "_scenario.json", {
        "schema": "vft.scenario/1", "scenario": "burst", "verdict": "FAIL",
        "offered": 10, "admitted": 8, "completed": 7, "expired": 1,
        "rejected": 2, "shed": 0, "time": NOW,
        "tenants": {"alpha": {"attainment_pct": 87.5}},
        "curve": [{"t1": 5, "tenants": {"alpha": {"attainment_pct": 100}}},
                  {"t1": 5, "tenants": {"alpha": {"attainment_pct": None}}}],
        "objectives": [{"tenant": "alpha", "min_attainment_pct": 95,
                        "actual": 87.5, "met": False}],
        "audit": {"pass": False}})
    talerts.AlertEngine(str(root), clock=lambda: time.time()).evaluate()


TREES = {f.__name__[5:]: f for f in (
    tree_classify, tree_straggler_and_queue, tree_serve_tenants_and_cache,
    tree_compile_cache_and_gc, tree_port_observatories)}


@pytest.fixture(params=sorted(TREES))
def tree(request, tmp_path):
    root = tmp_path / "out"
    root.mkdir()
    TREES[request.param](root, np.random.default_rng(len(request.param)))
    return request.param, root


def test_aggregate_equals_jax(tree):
    name, root = tree
    port = tfleet.aggregate(str(root), now=NOW)
    jax = jfleet.aggregate(str(root), now=NOW)
    assert port == jax
    assert port["hosts"]
    if name == "classify":
        assert port["n_hosts"] == {"live": 1, "stalled": 1, "finished": 1,
                                   "prior_run": 1, "unreadable": 1}
    if name == "straggler_and_queue":
        assert port["stragglers"] == ["busy-1"]
        assert port["queue"]["claimed"] == 1
    if name == "port_observatories":
        assert port["roofline"]["device"]["device_kind"] == \
            "NVIDIA H100 80GB HBM3"
        assert port["families"]["i3d"]["done"] >= 2
        assert {a["rule"] for a in port["alerts"]} == {"parity_drift"}


def test_render_equals_jax(tree):
    name, root = tree
    agg = tfleet.aggregate(str(root), now=NOW)
    cap = tfleet.CapacityPlanner(clock=lambda: NOW).observe(agg)
    jcap = jfleet.CapacityPlanner(clock=lambda: NOW).observe(
        copy.deepcopy(agg))
    assert cap == jcap
    port = tfleet.render(copy.deepcopy(agg), capacity=cap)
    jax = jfleet.render(copy.deepcopy(agg), capacity=jcap)
    assert _jax_names(port) == jax
    assert port[0] == f"fleet report: {root}"


def test_prom_dump_equals_jax_and_parses(tree):
    _, root = tree
    agg = tfleet.aggregate(str(root), now=NOW)
    cap = tfleet.CapacityPlanner(clock=lambda: NOW).observe(agg)
    port = tfleet.build_prom_dump(copy.deepcopy(agg), capacity=cap)
    jax = jfleet.build_prom_dump(copy.deepcopy(agg), capacity=cap)
    assert port == jax
    text = tmetrics.prometheus_text(port)
    assert text == jmetrics.prometheus_text(jax)
    body = [ln for ln in text.splitlines()
            if ln.strip() and not ln.startswith("#")]
    assert body and all(PROM_LINE.match(ln) for ln in body), body


# -- stitching and request lookup -------------------------------------------

def _trace_doc(host_id, anchor, ts, pid=7):
    other = {"schema": ttrace.TRACE_SCHEMA, "host": "synth", "pid": pid}
    if host_id is not None:
        other["host_id"] = host_id
    if anchor is not None:
        other["start_unix"] = anchor
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": "vft-host synth"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
         "args": {"name": "MainThread"}},
        {"ph": "X", "name": "video_attempt", "ts": ts, "dur": 10.0,
         "pid": pid, "tid": 1, "cat": "host"},
        {"ph": "i", "name": "fleet.steal", "ts": ts + 1, "pid": pid,
         "tid": 1}],
        "otherData": other}


@pytest.mark.parametrize("seed", range(3))
def test_stitch_traces_equals_jax(seed):
    """Anchored, unanchored and mixed hosts from the seed: the same
    stitched document, lanes and offsets."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(int(rng.integers(2, 5))):
        anchor = (None if seed == 1 and i == 0
                  else 1000.0 + float(rng.uniform(0, 9)))
        docs.append((f"host-{i}", _trace_doc(f"host-{i}", anchor,
                                             float(rng.uniform(0, 99)))))
    port = tfleet.stitch_traces(copy.deepcopy(docs))
    jax = jfleet.stitch_traces(copy.deepcopy(docs))
    assert port == jax
    assert port["otherData"]["aligned"] is (seed != 1)


def test_stitch_and_find_trace_files_equal_jax(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "_trace_host-a.json").write_text(
        json.dumps(_trace_doc("host-a", 1000.0, 100.0)))
    (tmp_path / "b" / "_trace.json").write_text(
        json.dumps(_trace_doc(None, 1005.0, 100.0, pid=9)))
    _write_hb(tmp_path / "b", _hb("host-b", NOW, pid=9))
    (tmp_path / "b" / "_trace_merged.json").write_text("{}")
    out = {}
    for name, mod in (("jax", jfleet), ("port", tfleet)):
        path, merged = mod.stitch(str(tmp_path),
                                  str(tmp_path / f"{name}.json"))
        out[name] = (Path(path).read_text(), merged)
    assert out["port"] == out["jax"]
    merged = out["port"][1]
    assert [h["host_id"] for h in merged["otherData"]["hosts"]] == \
        ["host-a", "host-b"]
    assert [h["offset_ms"] for h in merged["otherData"]["hosts"]] == \
        [0.0, 5000.0]
    # the stitched outputs never feed back in
    path, _ = tfleet.stitch(str(tmp_path))
    assert Path(path).name in ttrace.TRACE_OUTPUT_NAMES
    assert tfleet.find_trace_files(str(tmp_path)) == \
        jfleet.find_trace_files(str(tmp_path))
    assert [p.name for p in tfleet.find_trace_files(str(tmp_path))] == \
        ["_trace_host-a.json", "_trace.json"]


def test_find_request_equals_jax(tmp_path):
    root = tmp_path / "out"
    root.mkdir()
    rid = "reqabc123"
    with open(root / "_telemetry.jsonl", "w") as f:
        for r in (rid, "other"):
            f.write(json.dumps({"video": "a.mp4", "status": "done",
                                "request_id": r}) + "\n")
    (root / "_health.jsonl").write_text(json.dumps({
        "video": "a.mp4", "key": "resnet", "sig": "ff" * 32,
        "request_id": rid}) + "\n")
    (root / "_failures.jsonl").write_text(json.dumps({
        "video": "b.mp4", "category": "POISON", "request_id": rid}) + "\n")
    (root / "done").mkdir()
    (root / "done" / f"{rid}.json").write_text(json.dumps({"id": rid}))
    claim = root / "_queue" / "claimed" / "h1"
    claim.mkdir(parents=True)
    (claim / "x.json").write_text(json.dumps({"request_id": rid,
                                              "host_id": "h1"}))
    (root / "_trace_h1.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "video_attempt", "ts": 0, "dur": 1, "pid": 1,
         "tid": 1, "args": {"request": rid}}], "otherData": {}}))
    port = tfleet.find_request(str(root), rid)
    assert port == jfleet.find_request(str(root), rid)
    assert sorted(h.split()[0] for h in port) == [
        "claim", "failure", "health", "span", "spool", "trace"]
    assert tfleet.find_request(str(root), "missing") == []


# -- the capacity planner ---------------------------------------------------

def _agg(live=2, pending=0, claimed=0, idle_s=0.0, uptime_s=100.0,
         fleet_hosts=2, attainment=None, requests=0):
    return {"n_hosts": {"live": live, "stalled": 0, "finished": 0,
                        "prior_run": 0, "unreadable": 0},
            "queue": {"pending": pending, "claimed": claimed, "done": 0,
                      "quarantined": 0},
            "capacity_inputs": {"idle_wait_s_total": idle_s,
                                "uptime_s": uptime_s,
                                "fleet_hosts": fleet_hosts},
            "serve": {"hosts": [], "totals": {
                "requests": requests, "violations": 0,
                "attainment_pct": attainment}},
            "hosts": []}


#: (planner keywords, [(seconds after NOW, aggregate)]), after the cases
#: of tests/test_fleet_report.py
PLANNER_CASES = {
    "scale_up_needs_confirmation": (
        dict(confirm_ticks=2, cooldown_s=0.0),
        [(0, _agg(pending=10)), (2, _agg(pending=10))]),
    "cooldown_pins": (
        dict(confirm_ticks=1, cooldown_s=300.0),
        [(0, _agg(pending=10)), (10, _agg(idle_s=90.0)),
         (400, _agg(idle_s=95.0, uptime_s=101.0))]),
    "scale_down_needs_drained_idle_fleet": (
        dict(confirm_ticks=1, cooldown_s=0.0),
        [(0, _agg(pending=3, idle_s=90.0)), (5, _agg(idle_s=90.0)),
         (9, _agg(live=1, fleet_hosts=1, idle_s=90.0))]),
    "slo_attainment_slope": (
        dict(confirm_ticks=2, cooldown_s=0.0, slo_target_pct=95.0),
        [(0, _agg(attainment=92.0, requests=100)),
         (60, _agg(attainment=90.0, requests=120)),
         (120, _agg(attainment=93.0, requests=140))]),
    "idle_share_window_delta": (
        dict(confirm_ticks=1, cooldown_s=0.0),
        [(0, _agg(idle_s=10.0)), (25, _agg(idle_s=55.0, uptime_s=150.0))]),
    "no_live_host": (
        dict(), [(0, _agg(live=0, pending=4))]),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_capacity_planner_equals_jax(case):
    kw, steps = PLANNER_CASES[case]
    planners = [mod.CapacityPlanner(**kw) for mod in (tfleet, jfleet)]
    recs = [[p.observe(copy.deepcopy(agg), now=NOW + dt)
             for dt, agg in steps] for p in planners]
    assert recs[0] == recs[1]
    assert tfleet.render_capacity(recs[0][-1]) == \
        jfleet.render_capacity(recs[1][-1])
    assert any(r["pressure"] != "hold" for r in recs[0])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_planner_state_and_history_seed_cross_packages(tmp_path, writer,
                                                       reader):
    """The state file one package's planner persisted continues in the
    other's after a restart; a planner without one seeds its slope
    baseline from the other package's retained history."""
    mods = {"port": (tfleet, thistory), "jax": (jfleet, jhistory)}
    fleet_w, hist_w = mods[writer]
    fleet_r, _ = mods[reader]
    root = str(tmp_path / "state")
    p1 = fleet_w.CapacityPlanner.for_root(root, confirm_ticks=2,
                                          cooldown_s=300.0)
    assert p1.observe(_agg(pending=10), now=NOW)["streak"] == 1
    p2 = fleet_r.CapacityPlanner.for_root(root, confirm_ticks=2,
                                          cooldown_s=300.0)
    r2 = p2.observe(_agg(pending=10), now=NOW + 2)
    assert r2["recommendation"] == "scale_up" and r2["changed"]

    seeded = tmp_path / "seeded"
    hist_w.HistoryWriter(seeded, "h1").observe({
        "schema": hist_w.SAMPLE_SCHEMA, "time": NOW - 60.0, "host_id": "h1",
        "uptime_s": 100.0, "fleet": {"idle_wait_s_total": 10.0},
        "slo": {"requests": 100, "violations": 10}})
    p3 = fleet_r.CapacityPlanner.for_root(str(seeded), confirm_ticks=1,
                                          cooldown_s=0.0)
    assert p3._prev["attainment_pct"] == 90.0
    r3 = p3.observe(_agg(attainment=93.0, requests=120), now=NOW)
    assert r3["attainment_slope_pct_per_min"] == pytest.approx(3.0)


# -- main -------------------------------------------------------------------

def test_main_equals_jax(tmp_path, capsys):
    """One pass of ``--watch``, ``--prom``, ``--stitch`` and
    ``--fail-on-alert`` of each package on its own copy of one live tree
    with a firing alert: the same exit codes, the same output but for the
    paths and the tool names, and a textfile that parses."""
    import shutil
    src = tmp_path / "src"
    src.mkdir()
    _write_hb(src, _hb("live-1", time.time()))
    (src / "_trace.json").write_text(
        json.dumps(_trace_doc("live-1", 1000.0, 1.0)))
    write_json_atomic(src / "_parity_verdict.json", {
        "schema": jparity.VERDICT_SCHEMA, "family": "raft", "host": "vm",
        "flip": "dtype=bf16", "seams": {"head": {
            "ok": False, "max_abs": 9.0, "tol_max_abs": 0.5, "cos": 0.5,
            "tol_cos": 0.99, "note": None}},
        "first_drift": "head", "verdict": "FAIL", "time": NOW})
    talerts.AlertEngine(str(src), capture_incidents=False).evaluate()
    out = {}
    for name, mod in (("jax", jfleet), ("port", tfleet)):
        root = tmp_path / name
        shutil.copytree(src, root)
        rc = [mod.main([str(root), "--watch", "--iterations", "1"]),
              mod.main([str(root), "--prom", str(root / "f.prom"),
                        "--stitch", "--fail-on-alert"]),
              mod.main([str(root), "--request", "nothing"])]
        cap = capsys.readouterr()
        text = (cap.out + cap.err).replace(str(root), "ROOT")
        out[name] = (rc, _jax_names(text.splitlines()),
                     (root / "f.prom").read_text())
    assert out["port"][0] == out["jax"][0] == [0, 1, 1]
    assert out["port"][1] == [
        ln.replace("vft-fleet:", "fleet_report:") for ln in out["jax"][1]]
    prom = out["port"][2]
    assert 'ALERTS{alertname="parity_drift"' in prom
    assert 'vft_fleet_hosts{state="live"} 1' in prom
    assert all(PROM_LINE.match(ln) for ln in prom.splitlines()
               if ln.strip() and not ln.startswith("#"))
