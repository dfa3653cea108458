"""The port's retained history and alerting against the JAX package's.

Every case builds one synthetic input from a fixed ``NOW`` and a numpy
seed (a heartbeat dict, a sample series, an observation, or a tree of
artifacts on disk) and runs the JAX function and the port's on it. The
tolerance is exact: equal dicts, equal records, equal rendered lines, equal
Prometheus series. Alert records are compared without ``alert_id`` (a
``uuid4``), incident bundles by their list of artifact paths (the manifest
holds the absolute root and the alert's own id).

Held:
  - the constants, the rule table, ``AlertConfig``'s defaults and the
    schema file equal JAX's;
  - ``sample_from_heartbeat``, ``downsample``, ``window_delta``,
    ``window_rate`` and ``HistoryWriter``'s compaction;
  - each of the 12 built-in rules on a case that fires it, one that does
    not and a seeded random one;
  - ``observe_root`` on a tree with a queue, claims, history and a
    certify verdict;
  - the engine's pending, firing and resolved dwell, and the journal as the
    state across engines of both packages, both ways;
  - the incident bundle: the same artifacts as JAX's on the same tree, each
    package's ``verify_incident`` accepts the other's bundle and both catch
    a tampered artifact and a missing manifest;
  - ``current_alerts``, ``render_alerts`` and ``alerts_prom_series``, the
    ``main`` of each (``--window``, ``--prom``, ``--fail-on-firing``);
  - the recorder's hook points (``extra_sections``, ``tick_hooks``) count
    and render failures as JAX's do;
  - the run report (``telemetry/report.py``) against the JAX package's
    ``scripts/telemetry_report.py``: the same lines but the versions line,
    the same gates and textfile.
"""
import copy
import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu.telemetry import alerts as jalerts
from video_features_tpu.telemetry import history as jhistory
from video_features_tpu.telemetry import parity as jparity
from video_features_tpu.telemetry.jsonl import read_jsonl, write_json_atomic
from video_features_tpu_torch.telemetry import alerts as talerts
from video_features_tpu_torch.telemetry import history as thistory
from video_features_tpu_torch.telemetry import metrics as tmetrics

NOW = 1_700_000_000.0
PACKAGES = {"jax": (jalerts, jhistory), "port": (talerts, thistory)}


def _both(fn_name, *args, module="alerts", **kw):
    """``fn_name`` of each package on deep copies of the same arguments."""
    idx = 0 if module == "alerts" else 1
    return [getattr(mods[idx], fn_name)(*copy.deepcopy(args),
                                        **copy.deepcopy(kw))
            for mods in PACKAGES.values()]


def _no_id(recs):
    return [{k: v for k, v in r.items() if k != "alert_id"} for r in recs]


# -- the contracts ----------------------------------------------------------

@pytest.mark.parametrize("name", [
    "ALERTS_FILENAME", "INCIDENTS_DIRNAME", "SCHEMA_VERSION",
    "INCIDENT_SCHEMA", "ALERT_FIELDS", "STATES", "SEVERITIES",
    "INCIDENT_TRACE_WINDOW_S", "INCIDENT_TAIL_LINES", "_TAIL_NAMES"])
def test_alert_constants_equal_jax(name):
    assert getattr(talerts, name) == getattr(jalerts, name)


@pytest.mark.parametrize("name", [
    "HISTORY_PREFIX", "HISTORY_GLOB", "SAMPLE_SCHEMA", "TIERS",
    "COMPACT_EVERY"])
def test_history_constants_equal_jax(name):
    assert getattr(thistory, name) == getattr(jhistory, name)


def test_rule_table_config_and_schema_equal_jax():
    def table(mod):
        return [(r.name, r.severity, r.description, r.for_s, r.clear_for_s,
                 r.evaluate.__name__) for r in mod.BUILTIN_RULES]
    assert table(talerts) == table(jalerts) and len(table(talerts)) == 12
    assert dataclasses.asdict(talerts.AlertConfig()) == \
        dataclasses.asdict(jalerts.AlertConfig())
    assert talerts.load_alert_schema() == jalerts.load_alert_schema()
    assert set(talerts.load_alert_schema()["properties"]) == \
        set(talerts.ALERT_FIELDS)


# -- history ----------------------------------------------------------------

def _heartbeat(seed: int) -> dict:
    """A heartbeat with every section ``sample_from_heartbeat`` reads, each
    present or absent by the seed, its counters drawn from it."""
    rng = np.random.default_rng(seed)

    def n():
        return int(rng.integers(0, 50))
    hb = {"time": NOW - float(rng.uniform(0, 5)), "host_id": f"h{seed}",
          "run_id": f"r{seed}", "uptime_s": float(rng.uniform(1, 900)),
          "final": bool(rng.integers(0, 2)),
          "videos": {k: n() for k in ("done", "error")
                     if rng.integers(0, 3)},
          "videos_done": n(), "videos_per_s": float(rng.uniform(0, 3))}
    if rng.integers(0, 2):
        hb["cache"] = {"hits": {"resnet": n(), "i3d": n()},
                       "misses": {"i3d": n()}, "bypasses": {}}
    if rng.integers(0, 2):
        hb["compile_cache"] = {"hits": n(), "misses": n()}
    if rng.integers(0, 2):
        hb["fleet"] = {"active_claims": n(), "stolen": n(),
                       "reclaimed": n(), "quarantined": n(),
                       "idle_wait_s_total": float(rng.uniform(0, 9)),
                       "queue": {"pending": n(), "claimed": n(),
                                 "done": n()}}
    if rng.integers(0, 2):
        hb["serve"] = {"pending": n(), "slo": {"slo_s": 1.0,
                                               "requests": n() + 1,
                                               "violations": n()},
                       "tenants": {"alpha": {"requests": n() + 1,
                                             "violations": n()},
                                   "beta": {"requests": 0}}}
    if rng.integers(0, 2):
        hb["roofline"] = {"families": {"i3d": {"mfu": float(rng.uniform())},
                                       "raft": {"mfu": None}}}
    if rng.integers(0, 2):
        hb["gc"] = {"used_bytes": n() * 10**9,
                    "quota_bytes": rng.choice([None, 10**11])}
    return hb


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("nonfinite", [None, 3])
def test_sample_from_heartbeat_equals_jax(seed, nonfinite):
    port, jax = _both("sample_from_heartbeat", _heartbeat(seed),
                      nonfinite_total=nonfinite, module="history")
    assert port == jax
    assert port["schema"] == thistory.SAMPLE_SCHEMA
    json.dumps(port)


@pytest.mark.parametrize("seed", range(3))
def test_downsample_equals_jax(seed):
    rng = np.random.default_rng(seed)
    # a week and a half of irregular ticks, newest at NOW
    times = NOW - np.sort(rng.uniform(0, 10 * 86400, 4000))
    samples = [{"time": float(t), "i": i} for i, t in enumerate(times)]
    rng.shuffle(samples)
    port, jax = _both("downsample", samples, now=NOW, module="history")
    assert port == jax and 0 < len(port) < len(samples)


def _series(seed: int, n: int = 12):
    """``n`` samples ending at NOW, 30 s apart, with a cumulative counter
    (which resets once with seed 2), a gauge and a sparse field."""
    rng = np.random.default_rng(seed)
    counter = np.cumsum(rng.integers(0, 4, n))
    if seed == 2:
        counter[n // 2:] -= counter[n // 2]
    gauge = rng.integers(0, 20, n)
    out = []
    for i in range(n):
        s = {"time": NOW - (n - 1 - i) * 30.0,
             "videos": {"error": int(counter[i])},
             "slo": {"requests": int(5 * i), "violations": int(counter[i])},
             "fleet": {"queue": {"pending": int(gauge[i])}}}
        if i % 3:
            s["sparse"] = i
        out.append(s)
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("path,window,signed", [
    ("videos.error", 90.0, False), ("videos.error", 1e5, False),
    ("fleet.queue.pending", 120.0, True),
    ("fleet.queue.pending", 120.0, False), ("sparse", 45.0, False),
    ("missing.path", 60.0, False)])
def test_window_delta_equals_jax(seed, path, window, signed):
    s = _series(seed)
    port, jax = _both("window_delta", s, path, NOW, window,
                      allow_negative=signed, module="history")
    assert port == jax
    assert _both("latest", s, path, module="history") == \
        [jhistory.latest(s, path)] * 2


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("window", [60.0, 300.0, 1e5])
def test_window_rate_equals_jax(seed, window):
    s = _series(seed)
    port, jax = _both("window_rate", s, "slo.violations", "slo.requests",
                      NOW, window, module="history")
    assert port == jax


def test_history_writer_compaction_equals_jax(tmp_path):
    """Both writers append the same seeded samples (a week and more, past
    every tier) and compact at the same clock: the same files and the same
    series read back by either reader."""
    rng = np.random.default_rng(0)
    times = NOW - np.sort(rng.uniform(0, 9 * 86400, 600))[::-1]
    files = {}
    for name, (_, hist) in PACKAGES.items():
        w = hist.HistoryWriter(tmp_path / name, "host/X", clock=lambda: NOW)
        for t in times:
            w.observe({"schema": hist.SAMPLE_SCHEMA, "host_id": "host/X",
                       "time": float(t)})
        assert w.compact() < len(times)
        files[name] = Path(w.path)
    assert files["port"].name == files["jax"].name == \
        "_history_host-X.jsonl"
    assert files["port"].read_text() == files["jax"].read_text()
    for _, hist in PACKAGES.values():
        assert hist.read_history(str(tmp_path / "port")) == \
            jhistory.read_history(str(tmp_path / "jax"))


# -- the rules --------------------------------------------------------------

def _samples(host="h1", n=10, dt=30.0, t0=None, **series):
    """n samples ending at NOW; each kwarg a ``__``-separated path with n
    values (``slo__requests=[...]``)."""
    t0 = NOW - (n - 1) * dt if t0 is None else t0
    out = []
    for i in range(n):
        s = {"schema": jhistory.SAMPLE_SCHEMA, "time": t0 + i * dt,
             "host_id": host, "run_id": "r", "uptime_s": i * dt,
             "final": False,
             "videos": {"done": i, "skipped": 0, "error": 0,
                        "quarantined": 0}}
        for key, vals in series.items():
            cur = s
            parts = key.split("__")
            for part in parts[:-1]:
                cur = cur.setdefault(part, {})
            cur[parts[-1]] = vals[i]
        out.append(s)
    return out


def _host(host_id, state="live", age=1.0, prior=False):
    hb = {"host_id": host_id, "run_id": "r", "time": NOW - age,
          "interval_s": 2.0, "final": state == "FINISHED"}
    return {"path": f"_heartbeat_{host_id}.json", "dir": ".", "hb": hb,
            "state": state, "age_s": age, "prior_run": prior}


def _obs(hosts=(), queue=None, claims=None, tracked=False, hist=None,
         verdicts=None):
    return {"root": "/r", "time": NOW, "hosts": list(hosts),
            "n_live": sum(1 for e in hosts if e.get("state") == "live"),
            "queue": queue, "claims": claims or {},
            "claims_tracked": tracked, "history": hist or {},
            "parity": verdicts or []}


def _verdict(bad=()):
    seams = {}
    for seam in jparity.SEAMS:
        ok = seam not in bad
        band = jparity.tolerance_for("raft", seam)
        seams[seam] = {"pairs": 2, "mean_abs": 0.0, "max_rel": 0.0,
                       "max_abs": 0.0 if ok else band["max_abs"] * 5,
                       "cos": 1.0 if ok else 0.5,
                       "tol_max_abs": band["max_abs"],
                       "tol_cos": band["cos"], "why": band["why"],
                       "ok": ok, "note": None}
    first = next((s for s in jparity.SEAMS if s in bad), None)
    return {"schema": jparity.VERDICT_SCHEMA, "family": "raft", "host": "vm",
            "flip": "dtype=bf16", "ref": {"precision": "float32"},
            "cand": {"precision": "bfloat16"},
            "corpus": [{"video": "v.mp4", "sha256": None}], "seams": seams,
            "first_drift": first, "verdict": "FAIL" if first else "PASS",
            "time": NOW}


def _noise(seed, n=10):
    """A seeded cumulative counter of n values."""
    return [int(v) for v in np.cumsum(
        np.random.default_rng(seed).integers(0, 3, n))]


#: per rule: (an observation that fires it, one that does not); the
#: seeded third case of each rule comes from :func:`_random_obs`
RULE_CASES = {
    "slo_burn_rate": (
        _obs(hist={"h1": _samples(
            n=13, dt=300.0, slo__requests=[20 * i for i in range(13)],
            slo__violations=[0] * 13,
            tenants__noisy__requests=[10 * i for i in range(12)] + [130],
            tenants__noisy__violations=[0] * 12 + [10],
            tenants__calm__requests=[10 * i for i in range(13)],
            tenants__calm__violations=[0] * 13)}),
        _obs(hist={"h1": _samples(slo__requests=[5 * i for i in range(10)],
                                  slo__violations=[0] * 10)})),
    "host_stalled": (
        _obs(hosts=[_host("dead-1", "STALLED", 120.0), _host("b1", "live")],
             claims={"dead-1": 1}, tracked=True),
        _obs(hosts=[_host("dead-1", "STALLED", 200.0),
                    _host("c", "STALLED", prior=True)], tracked=True)),
    "nonfinite_features": (
        _obs(hist={"h1": _samples(nonfinite_total=[0] * 8 + [2, 2])}),
        _obs(hist={"h1": _samples(nonfinite_total=[3] * 10)})),
    "quarantine_spike": (
        _obs(hist={"h1": _samples(
            fleet__queue__quarantined=[0] * 9 + [1])}),
        _obs(hist={"h1": _samples(fleet__queue__quarantined=[1] * 10)})),
    "queue_depth_growth": (
        _obs(hosts=[_host("h1")], queue={"pending": 20}, hist={
            "h1": _samples(fleet__queue__pending=list(range(2, 22, 2)))}),
        _obs(hosts=[_host("h1")], queue={"pending": 20}, hist={
            "h1": _samples(fleet__queue__pending=[
                40, 36, 32, 28, 24, 22, 21, 20, 20, 20])})),
    "reclaim_spike": (
        _obs(hist={"h1": _samples(
            fleet__reclaimed=[0, 0, 0, 0, 0, 1, 2, 3, 3, 3])}),
        _obs(hist={"h1": _samples(fleet__reclaimed=[2] * 10)})),
    "failure_spike": (
        _obs(hist={"h1": _samples(videos__error=[0] * 8 + [1, 1])}),
        _obs(hist={"h1": _samples()})),
    "cache_hit_collapse": (
        _obs(hist={"h1": _samples(
            cache__hits=[0, 90, 180, 270, 360, 450, 540, 630, 632, 634],
            cache__misses=[0, 10, 20, 30, 40, 50, 60, 70, 108, 146])}),
        _obs(hist={"h1": _samples(
            cache__hits=[0] * 10,
            cache__misses=[20 * i for i in range(10)])})),
    "compile_cache_collapse": (
        _obs(hist={"h1": _samples(
            compile_cache__hits=[0, 9, 18, 27, 36, 45, 54, 63, 63, 63],
            compile_cache__misses=[0, 1, 2, 3, 4, 5, 6, 7, 17, 27])}),
        _obs(hist={"h1": _samples(
            compile_cache__hits=[9 * i for i in range(10)],
            compile_cache__misses=[i for i in range(10)])})),
    "mfu_regression": (
        _obs(hist={"h1": _samples(mfu__r21d=[
            0.60, 0.61, 0.59, 0.62, 0.60, 0.61, 0.60, 0.59, 0.61, 0.30])}),
        _obs(hist={"h1": _samples(mfu__r21d=[0.6] * 10)})),
    "disk_pressure": (
        _obs(hist={"h1": _samples(
            gc__used_bytes=[10**9 * (50 + 3 * i) for i in range(10)],
            gc__quota_bytes=[10**11] * 10),
            "h2": _samples(host="h2", gc__used_bytes=[95 * 10**9] * 10,
                           gc__quota_bytes=[10**11] * 10)}),
        _obs(hist={"h1": _samples(gc__used_bytes=[10**9] * 10,
                                  gc__quota_bytes=[10**11] * 10)})),
    "parity_drift": (
        _obs(verdicts=[_verdict(bad=("backbone", "head"))]),
        _obs(verdicts=[_verdict()])),
}


def _random_obs(seed: int) -> dict:
    """Every series the rules read, drawn from the seed, on two hosts, one
    stalled while holding a claim."""
    hist = {}
    for h, host in enumerate(("h1", "h2")):
        s = seed * 10 + h
        hist[host] = _samples(
            host=host, slo__requests=[5 * v for v in _noise(s)],
            slo__violations=_noise(s + 1),
            fleet__reclaimed=_noise(s + 2),
            fleet__queue__quarantined=_noise(s + 3),
            fleet__queue__pending=_noise(s + 4),
            nonfinite_total=_noise(s + 5),
            cache__hits=[10 * v for v in _noise(s + 6)],
            cache__misses=[10 * v for v in _noise(s + 7)],
            compile_cache__hits=_noise(s + 8),
            compile_cache__misses=_noise(s + 9),
            mfu__i3d=[v / 40.0 for v in _noise(s + 10)],
            gc__used_bytes=[10**9 * v for v in _noise(s + 11)],
            gc__quota_bytes=[3 * 10**10] * 10,
            videos__error=_noise(s + 12))
    return _obs(hosts=[_host("h1", "STALLED", 120.0), _host("h2")],
                queue={"pending": _noise(seed + 5)[-1]},
                claims={"h1": 2}, tracked=True, hist=hist,
                verdicts=[_verdict(bad=("head",) if seed % 2 else ())])


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_each_rule_equals_jax(rule):
    """The rule fires on its first case and not on its second in both
    packages, with equal findings; equal findings on three seeded random
    observations as well."""
    assert set(RULE_CASES) == {r.name for r in jalerts.BUILTIN_RULES}
    fns = {name: {r.name: r.evaluate for r in mod.BUILTIN_RULES}[rule]
           for name, (mod, _) in PACKAGES.items()}
    cfg = jalerts.AlertConfig(spike_window_s=40.0) \
        if "collapse" in rule else jalerts.AlertConfig()
    tcfg = talerts.AlertConfig(**dataclasses.asdict(cfg))
    fire, quiet = RULE_CASES[rule]
    for case, want in ((fire, True), (quiet, False)) + tuple(
            (_random_obs(s), None) for s in range(3)):
        port = fns["port"](copy.deepcopy(case), tcfg)
        jax = fns["jax"](copy.deepcopy(case), cfg)
        assert port == jax
        if want is not None:
            assert bool(port) is want, (rule, port)


def _tree(root: Path) -> Path:
    """A root with a stalled host holding a queue claim, a finished one, a
    failure journal, spans, a history series that spikes failures, a
    certify verdict that drifted at ``head`` and a trace."""
    root.mkdir(parents=True)
    write_json_atomic(root / "_heartbeat_hostA.json",
                      {"run_id": "r1", "host_id": "hostA",
                       "time": NOW - 100, "interval_s": 2.0,
                       "final": False})
    sub = root / "i3d"
    sub.mkdir()
    write_json_atomic(sub / "_heartbeat_hostB.json",
                      {"run_id": "r2", "host_id": "hostB", "time": NOW - 1,
                       "interval_s": 2.0, "final": True})
    claimed = root / "_queue" / "claimed" / "hostA"
    claimed.mkdir(parents=True)
    (claimed / "item.json").write_text("{}")
    (root / "_queue" / "pending").mkdir()
    (root / "_failures.jsonl").write_text(
        json.dumps({"video": "v.mp4", "category": "FATAL"}) + "\n")
    (sub / "_telemetry.jsonl").write_text(
        json.dumps({"video": "v.mp4", "status": "error",
                    "feature_type": "i3d"}) + "\n")
    with open(sub / "_history_hostB.jsonl", "w") as f:
        for s in _samples(host="hostB", videos__error=[0] * 8 + [1, 1]):
            f.write(json.dumps(s) + "\n")
    write_json_atomic(sub / "_parity_verdict.json", _verdict(bad=("head",)))
    (sub / "_trace.json").write_text(json.dumps({
        "traceEvents": [{"ph": "X", "name": "video_attempt", "ts": 5.0,
                         "dur": 2.0, "pid": 1, "tid": 1}],
        "otherData": {"host_id": "hostB", "start_unix": NOW - 50}}))
    return root


def test_observe_root_equals_jax(tmp_path):
    root = _tree(tmp_path / "out")
    port, jax = _both("observe_root", str(root), now=NOW)
    assert port == jax
    assert port["claims"] == {"hostA": 1} and port["claims_tracked"]
    assert [e["state"] for e in port["hosts"]] == ["STALLED", "FINISHED"]
    assert list(port["history"]) == ["hostB"] and len(port["parity"]) == 1


# -- the engine -------------------------------------------------------------

def _flag_rule(mod, flag, **kw):
    def ev(obs, cfg):
        if flag.get("on"):
            return [{"scope": "s1", "summary": "synthetic condition",
                     "value": 1.0, "threshold": 1.0}]
        return []
    return mod.AlertRule("synthetic", "ticket", "test", ev, **kw)


#: (rule keywords, [(seconds after NOW, condition on)]) of each dwell case
DWELL_CASES = {
    "pending_fires_then_resolves": (
        dict(for_s=10.0), [(0, True), (5, True), (11, True), (20, True),
                           (30, False)]),
    "pending_clears_without_firing": (
        dict(for_s=60.0), [(0, True), (5, False)]),
    "clear_dwell_holds_firing": (
        dict(clear_for_s=30.0), [(0, True), (10, False), (20, True),
                                 (25, False), (60, False)]),
    "fires_at_once": (dict(), [(0, True), (1, True), (2, False)]),
}


@pytest.mark.parametrize("case", sorted(DWELL_CASES))
def test_engine_dwell_equals_jax(tmp_path, case):
    """Each engine through the same sequence of conditions: the same
    transitions at the same steps, each record valid under both schemas,
    one ``alert_id`` an episode, the same journal and active alerts."""
    kw, steps = DWELL_CASES[case]
    emitted = {}
    for name, (mod, _) in PACKAGES.items():
        flag = {}
        eng = mod.AlertEngine(tmp_path / name,
                              rules=(_flag_rule(mod, flag, **kw),),
                              capture_incidents=False, run_id="r")
        emitted[name] = []
        for dt, on in steps:
            flag["on"] = on
            emitted[name].append(eng.evaluate(obs=_obs(), now=NOW + dt))
        assert len({r["alert_id"] for step in emitted[name]
                    for r in step}) == 1
        for step in emitted[name]:
            for r in step:
                assert not jalerts.validate_alert(r)
                assert not talerts.validate_alert(r)
        assert eng.heartbeat_section()["eval_errors"] == 0
    assert [_no_id(s) for s in emitted["port"]] == \
        [_no_id(s) for s in emitted["jax"]]
    assert any(emitted["port"])
    journal = {n: _no_id(read_jsonl(tmp_path / n / "_alerts.jsonl"))
               for n in PACKAGES}
    assert journal["port"] == journal["jax"]
    assert _no_id(talerts.current_alerts(tmp_path / "port")) == \
        _no_id(jalerts.current_alerts(tmp_path / "jax"))


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_journal_is_the_state_across_packages(tmp_path, first, second):
    """An episode one package's engine fired, a fresh engine of the other
    adopts (no second firing while the condition holds) and resolves, with
    the same alert id."""
    flag = {"on": True}
    mods = {n: m for n, (m, _) in PACKAGES.items()}
    e1 = mods[first].AlertEngine(
        tmp_path, rules=(_flag_rule(mods[first], flag),),
        capture_incidents=False)
    fired = e1.evaluate(obs=_obs(), now=NOW)
    e2 = mods[second].AlertEngine(
        tmp_path, rules=(_flag_rule(mods[second], flag),),
        capture_incidents=False)
    assert e2.evaluate(obs=_obs(), now=NOW + 5) == []
    flag["on"] = False
    resolved = e2.evaluate(obs=_obs(), now=NOW + 60)
    assert [r["state"] for r in fired + resolved] == ["firing", "resolved"]
    assert resolved[0]["alert_id"] == fired[0]["alert_id"]
    assert mods[first].current_alerts(tmp_path) == []


def test_rule_failure_is_counted_like_jax(tmp_path, capsys):
    def boom(obs, cfg):
        raise RuntimeError("bad rule")
    sections = {}
    for name, (mod, _) in PACKAGES.items():
        eng = mod.AlertEngine(tmp_path / name, capture_incidents=False,
                              rules=(mod.AlertRule("boom", "page", "x",
                                                   boom),))
        assert eng.evaluate(obs=_obs(), now=NOW) == []
        sections[name] = eng.heartbeat_section()
    assert sections["port"] == sections["jax"]
    assert sections["port"]["eval_errors"] == 1
    out = capsys.readouterr().out
    assert out.count("alerts: rule boom failed: RuntimeError: bad rule") == 2


# -- the flight recorder ----------------------------------------------------

def _bundle(root: Path, mod) -> Path:
    eng = mod.AlertEngine(root, clock=lambda: NOW, run_id="r")
    fired = [r for r in eng.evaluate(now=NOW) if r["state"] == "firing"]
    assert fired and all(r["incident"] for r in fired)
    return root / fired[0]["incident"], fired


def test_bundle_artifacts_equal_jax_and_verify_across(tmp_path):
    """Each package fires on its own copy of one tree: the same records,
    bundles with the same artifact paths, bytes and hashes but for
    ``alert.json`` (the id) and the alert tail; each package's
    ``verify_incident`` accepts both bundles."""
    root = _tree(tmp_path / "tree")
    bundles, fired = {}, {}
    for name, (mod, _) in PACKAGES.items():
        copy_root = tmp_path / name
        shutil.copytree(root, copy_root)
        bundles[name], fired[name] = _bundle(copy_root, mod)
    assert _no_id([{k: v for k, v in r.items() if k != "incident"}
                   for r in fired["port"]]) == \
        _no_id([{k: v for k, v in r.items() if k != "incident"}
                for r in fired["jax"]])
    assert {r["rule"] for r in fired["port"]} == {
        "host_stalled", "failure_spike", "parity_drift"}
    mans = {n: json.loads((b / "manifest.json").read_text())
            for n, b in bundles.items()}
    arts = {n: {a["path"]: a for a in m["artifacts"]}
            for n, m in mans.items()}
    assert sorted(arts["port"]) == sorted(arts["jax"])
    assert {"alert.json", "trace_window.json", "queue.json"} <= \
        set(arts["port"])
    assert any(p.startswith("heartbeats/hb-") for p in arts["port"])
    for path in arts["port"]:
        if path != "alert.json" and "_alerts" not in path:
            assert arts["port"][path] == arts["jax"][path], path
    for b in bundles.values():
        assert jalerts.verify_incident(b) == []
        assert talerts.verify_incident(b) == []


@pytest.mark.parametrize("maker", ["jax", "port"])
@pytest.mark.parametrize("tamper", ["artifact", "manifest"])
def test_both_verifiers_catch_a_tampered_bundle(tmp_path, maker, tamper):
    bundle, _ = _bundle(_tree(tmp_path / "out"), PACKAGES[maker][0])
    if tamper == "artifact":
        victim = bundle / "alert.json"
        victim.write_text(victim.read_text() + "x")
    else:
        (bundle / "manifest.json").unlink()
    errs = [mod.verify_incident(bundle) for mod, _ in PACKAGES.values()]
    assert errs[0] and errs[1]
    if tamper == "artifact":
        assert errs[0] == errs[1] and "mismatch" in errs[0][0]


def test_bundles_are_never_read_back_as_live_artifacts(tmp_path):
    root = _tree(tmp_path / "out")
    _bundle(root, talerts)
    port, jax = _both("observe_root", str(root), now=NOW)
    assert port == jax
    assert len(port["hosts"]) == 2 and list(port["history"]) == ["hostB"]


# -- render and prom --------------------------------------------------------

def test_render_and_prom_series_equal_jax(tmp_path):
    root = _tree(tmp_path / "out")
    _bundle(root, talerts)
    active = talerts.current_alerts(root)
    assert _no_id(active) == _no_id(jalerts.current_alerts(root))
    assert active[0]["state"] == "firing"
    lines = _both("render_alerts", active)
    assert lines[0] == lines[1] and "3 firing / 0 pending" in lines[0][0]
    series = _both("alerts_prom_series", active)
    assert series[0] == series[1] and len(series[0]) == 3
    from video_features_tpu.telemetry.metrics import prometheus_text
    assert tmetrics.prometheus_text({"series": series[0]}) == \
        prometheus_text({"series": series[1]})
    # a manifest newer than every record: a prior run's episodes
    assert talerts.current_alerts(root, started_time=NOW + 1) == []


def test_alert_cli_resolves_like_jax(tmp_path, capsys):
    """``main`` of each package on a copy of one tree: firing on the first
    pass, every episode resolved once the stalled host's heartbeat is fresh
    and the spike has left a shrunken window; the same output but for the
    bundle ids, and ``--fail-on-firing`` exits 1 while firing."""
    root = _tree(tmp_path / "tree")
    write_json_atomic(root / "i3d" / "_parity_verdict.json", _verdict())
    outs = {}
    for name, (mod, _) in PACKAGES.items():
        r = tmp_path / name
        shutil.copytree(root, r)
        rc = [mod.main([str(r), "--no-incidents", "--fail-on-firing"])]
        write_json_atomic(r / "_heartbeat_hostA.json",
                          {"run_id": "r1", "host_id": "hostA",
                           "time": time.time(), "interval_s": 2.0,
                           "final": True})
        rc.append(mod.main([str(r), "--window", "0.05",
                            "--prom", str(r / "a.prom")]))
        outs[name] = (rc, capsys.readouterr().out.replace(str(r), "ROOT"))
        assert mod.current_alerts(r) == []
        assert "ALERTS" not in (r / "a.prom").read_text()
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == [1, 0]
    assert "-> RESOLVED" in outs["port"][1]


def test_run_report_equals_jax(tmp_path, capsys):
    """The port's run report and the JAX package's on one run dir: the same
    lines but the manifest's versions line (torch, CUDA and the device in
    the port's, jax in JAX's), the same exit codes of the alert gate,
    which lifts once a newer run's manifest makes the firing record a
    prior run's."""
    import sys

    from video_features_tpu_torch.telemetry import report as treport
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    try:
        import telemetry_report as jreport
    finally:
        sys.path.pop(0)
    root = _tree(tmp_path / "out")
    (root / "i3d" / "_parity_verdict.json").unlink()
    write_json_atomic(root / "_run.json", {
        "run_id": "r1", "started_time": NOW - 200, "feature_type": "i3d",
        "host": "vm", "wall_s": 3.5, "videos_per_s": 0.2,
        "tally": {"done": 0, "error": 1}, "compile_cache": {},
        "health": {"i3d": {"records": 4, "nan": 0, "inf": 0}},
        "roofline": {"families": {"i3d": {"mfu": 0.0185,
                                          "effective_tflops": 14.3,
                                          "verdict": "host-bound"}}},
        "stage_totals": {"decode": {"s": 0.2, "calls": 3},
                         "forward": {"s": 1.5, "calls": 1}},
        "versions": {"jax": "0.4", "torch": "2.5", "torch_cuda": "12.4"},
        "topology": {"platform": "gpu", "device_name": "NVIDIA H100",
                     "n_local_devices": 1, "n_global_devices": 1,
                     "process_index": 0, "process_count": 1},
        "git": {"commit": "abc", "dirty": False},
        "metrics": {"series": []}})
    with open(root / "_telemetry.jsonl", "a") as f:
        f.write(json.dumps({"video": "w.mp4", "status": "error",
                            "attempts": 2, "wall_s": 1.5, "category": "FATAL",
                            "error": "ENOSPC", "stages": {
                                "decode": {"s": 0.2, "calls": 3}}}) + "\n")
    _bundle(root, talerts)
    out = {}
    for name, mod in (("jax", jreport), ("port", treport)):
        rc = [mod.main([str(root), "--fail-on-alert", "--fail-on-failures",
                        "--prom", str(tmp_path / "run.prom")])]
        lines = capsys.readouterr()
        out[name] = (rc, lines.out.splitlines(), lines.err,
                     (tmp_path / "run.prom").read_text())
    header = [i for i, ln in enumerate(out["port"][1]) if "git=" in ln]
    assert len(header) == 1
    i = header[0]
    assert "torch=2.5  cuda=12.4  device=NVIDIA H100" in out["port"][1][i]
    assert "jax=0.4" in out["jax"][1][i]
    for name in out:
        del out[name][1][i]
    assert out["port"] == out["jax"]
    assert out["port"][0] == [1]
    assert "== alerts ==  2 firing" in "\n".join(out["port"][1])
    write_json_atomic(root / "_run.json", {"run_id": "r2",
                                           "started_time": time.time()})
    assert treport.main([str(root), "--fail-on-alert"]) == 0 == \
        jreport.main([str(root), "--fail-on-alert"])


def test_recorder_hooks_count_failures_like_jax(tmp_path, capsys):
    """The recorder's two hook points: a section callback renders into the
    heartbeat and a failed one renders JAX's error marker; a failing tick
    hook is counted, its first failure printed once, and the heartbeat is
    written all the same; a working hook sees each heartbeat."""
    from video_features_tpu.telemetry import recorder as jrec
    from video_features_tpu_torch.telemetry import recorder as trec

    def boom(*_):
        raise RuntimeError("hook down")
    out = {}
    for name, mod, errors in (("jax", jrec, "_tick_hook_errors"),
                              ("port", trec, "tick_hook_errors")):
        r = mod.TelemetryRecorder(str(tmp_path / name), host_id="h")
        seen = []
        r.extra_sections["ok"] = lambda: {"n": 1}
        r.extra_sections["bad"] = boom
        r.tick_hooks += [boom, seen.append]
        r.write_heartbeat()
        r.write_heartbeat(final=True)
        hb = json.loads((tmp_path / name / "_heartbeat_h.json").read_text())
        out[name] = (getattr(r, errors), hb["ok"], hb["bad"],
                     [s["final"] for s in seen])
    assert out["port"] == out["jax"] == (
        2, {"n": 1}, {"error": "section callback failed"}, [False, True])
    assert capsys.readouterr().out.count(
        "telemetry: heartbeat hook failed: RuntimeError: hook down") == 2
