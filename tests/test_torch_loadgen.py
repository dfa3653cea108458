"""The port's traffic drills (``loadgen.py``) against the JAX package's.

Every case of JAX ``tests/test_loadgen.py``, run against the port:
- spec validation fails loudly at load; the arrival-rate shapes; Zipf
  skew concentrates on the hot ranks;
- the replay contract: the same YAML and seed give byte-identical journal
  bytes, composed scenarios leave each other's streams untouched, every
  journal record is valid under the port's ``loadgen_event`` schema;
- the serving satellites: an expired request counts against SLO
  attainment, the 429's ``Retry-After`` includes the fair-share backlog,
  and history samples carry per-tenant attainment;
- one drill end to end over real HTTP (the port's ``GatewayServer`` and
  ``ServeLoop`` with the video step stubbed by a 2 ms sleep, as in JAX):
  ``_scenario.json`` valid under the port's schema, tallies that reconcile
  with the journal, the curve rendered by the port's fleet report, the
  port's audit green; and the audit flags an inconsistent artifact.

Parity with the JAX package on the CPU: the ``--dry-run`` journal of each
of the five ``scenarios/*.yml`` is byte-identical; ``offered_events``,
``write_tenant_table`` and ``load_scenario``'s error messages are equal;
``build_report(now=...)`` over one recorded tree is equal; both schema
files are equal as JSON; and the JAX audit and the port's give the same
``(ok, violations)`` on the drill's tree and on the tampered artifact.
"""
import json
import threading
import time
from collections import deque
from pathlib import Path

import pytest

from video_features_tpu import loadgen as jloadgen
from video_features_tpu_torch import loadgen, serve
from video_features_tpu_torch.gateway import GatewayServer
from video_features_tpu_torch.loadgen import (DrillRunner, content_key,
                                              load_scenario, offered_events,
                                              synthesize_corpus,
                                              write_tenant_table)
from video_features_tpu_torch.telemetry import schema as tschema
from video_features_tpu_torch.telemetry.jsonl import read_jsonl

REPO = Path(__file__).resolve().parent.parent
SCENARIOS = sorted((REPO / "scenarios").glob("*.yml"))

#: seconds any thread, drain or HTTP wait of this file may take
WAIT_S = 60

SCN_A = """
scenario: alpha_stream
seed: 101
duration_s: 12
clock: virtual
speedup: 40
# generous: at x40 a 0.02s wall poll tick is 0.8 VIRTUAL seconds, so
# queueing granularity alone costs whole virtual seconds of wait
slo_s: 60
curve_windows: 4
arrivals:
  process: constant
  rate_rps: 2.0
corpus:
  n_items: 5
  zipf_s: 1.1
tenants:
  alpha:
    key: alpha-k
    share: 1.0
    priority: high
    rate_rps: 10
    burst: 40
    max_inflight: 32
objectives:
  - min_admitted_pct: 90
  - min_attainment_pct: 80
"""

SCN_B = """
scenario: beta_stream
seed: 101
duration_s: 12
clock: virtual
speedup: 40
arrivals:
  process: burst
  rate_rps: 0.5
  burst:
    period_s: 6
    length_s: 2
    rate_rps: 4.0
corpus:
  n_items: 3
  zipf_s: 0.0
tenants:
  beta:
    key: beta-k
    share: 1.0
    priority: low
    rate_rps: 10
    burst: 40
    max_inflight: 32
"""

#: JAX tests/test_loadgen.py's malformed specs and the word each error names
MALFORMED = [
    ("scenario: Bad-Name\nseed: 1\ntenants:\n  a: {key: k}\n", "scenario"),
    ("scenario: ok\ntenants:\n  a: {key: k}\n", "seed"),
    ("scenario: ok\nseed: 1\n", "tenant"),
    ("scenario: ok\nseed: 1\ntenants:\n  a: {key: k}\n"
     "arrivals: {process: lumpy}\n", "process"),
    ("scenario: ok\nseed: 1\ntenants:\n  a: {key: k,"
     " priority: urgent}\n", "priority"),
    ("scenario: ok\nseed: 1\ntenants:\n  a: {key: k,"
     " timeout_s: [5, 1]}\n", "timeout_s"),
    ("scenario: ok\nseed: 1\ntenants:\n  a: {key: k}\n"
     "objectives:\n  - min_sparkle: 1\n", "unknown"),
    ("scenario: ok\nseed: 1\ntenants:\n  a: {key: k}\n"
     "objectives:\n  - tenant: ghost\n    min_expired: 1\n", "ghost"),
]


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _schema(name):
    return tschema.load_schema(
        str(REPO / "video_features_tpu_torch" / "telemetry" / name))


# -- spec validation ----------------------------------------------------------

def test_load_scenario_rejects_malformed(tmp_path):
    for i, (text, needle) in enumerate(MALFORMED):
        p = _write(tmp_path, f"bad{i}.yml", text)
        with pytest.raises(ValueError, match=needle):
            load_scenario(p)


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_load_scenario_errors_match_jax(tmp_path, case):
    p = _write(tmp_path, "bad.yml", MALFORMED[case][0])
    with pytest.raises(ValueError) as want:
        jloadgen.load_scenario(p)
    with pytest.raises(ValueError) as got:
        load_scenario(p)
    assert str(got.value) == str(want.value)


def test_rate_shapes(tmp_path):
    spec = load_scenario(_write(tmp_path, "b.yml", SCN_B))
    # floor between trains, floor+burst inside one
    assert loadgen._rate_at(spec, 3.0) == pytest.approx(0.5)
    assert loadgen._rate_at(spec, 1.0) == pytest.approx(4.5)
    assert loadgen._max_rate(spec) == pytest.approx(4.5)


def test_zipf_skew_concentrates_on_hot_ranks(tmp_path):
    spec = load_scenario(_write(tmp_path, "a.yml", SCN_A))
    events = [e for e in offered_events(spec) if e["event"] == "request"]
    hot = content_key(spec, 0)
    n_hot = sum(1 for e in events for v in e["videos"] if v == hot)
    total = sum(len(e["videos"]) for e in events)
    # zipf s=1.1 over 5 items: rank 0 carries ~44% of draws; uniform
    # would be 20%
    assert n_hot / total > 0.30


# -- the replay contract ------------------------------------------------------

def test_dry_run_journal_bit_identical(tmp_path):
    spec_path = _write(tmp_path, "a.yml", SCN_A)
    outs = []
    for d in ("r1", "r2"):
        rc = loadgen.loadgen_main([
            spec_path, "--spool", str(tmp_path / "spool"),
            "--out", str(tmp_path / d), "--host-id", "h", "--dry-run"])
        assert rc == 0
        outs.append((tmp_path / d / "_loadgen_h.jsonl").read_bytes())
    assert outs[0] == outs[1]
    assert outs[0]  # not vacuously identical


@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: p.stem)
def test_dry_run_journal_matches_jax(tmp_path, path):
    """The port's ``--dry-run`` journal of a checked-in scenario is the
    JAX package's byte for byte."""
    for name, main in (("port", loadgen.loadgen_main),
                       ("jax", jloadgen.loadgen_main)):
        assert main([str(path), "--spool", str(tmp_path / "spool"),
                     "--out", str(tmp_path / name), "--host-id", "h",
                     "--dry-run"]) == 0
    got = (tmp_path / "port" / "_loadgen_h.jsonl").read_bytes()
    assert got == (tmp_path / "jax" / "_loadgen_h.jsonl").read_bytes()
    assert got.count(b'"event": "request"') > 0


def test_offered_events_and_tenant_table_match_jax(tmp_path):
    specs = [load_scenario(str(p)) for p in SCENARIOS]
    for spec in specs:
        assert spec == jloadgen.load_scenario(
            str(REPO / "scenarios" / f"{spec['scenario']}.yml"))
        assert offered_events(spec) == jloadgen.offered_events(spec)
    for speedup in (1.0, 40.0):
        write_tenant_table(specs[:2], str(tmp_path / "port.yml"), speedup)
        jloadgen.write_tenant_table(specs[:2], str(tmp_path / "jax.yml"),
                                    speedup)
        assert (tmp_path / "port.yml").read_bytes() == \
            (tmp_path / "jax.yml").read_bytes()


@pytest.mark.parametrize("name", ["loadgen_event.schema.json",
                                  "scenario.schema.json"])
def test_schema_files_equal_jax(name):
    jax_doc = json.loads(
        (REPO / "video_features_tpu" / "telemetry" / name).read_text())
    assert _schema(name) == jax_doc


def test_journal_records_validate_against_schema(tmp_path):
    spec = load_scenario(_write(tmp_path, "a.yml", SCN_A))
    schema = _schema("loadgen_event.schema.json")
    events = offered_events(spec)
    assert events[0]["event"] == "begin"
    assert events[-1]["event"] == "end"
    assert events[-1]["offered"] == len(events) - 2
    for ev in events:
        assert tschema.validate(ev, schema) == []
        assert set(ev) <= set(loadgen.LOADGEN_FIELDS)
    assert set(schema["properties"]) == set(loadgen.LOADGEN_FIELDS)
    # a record the schema refuses is refused
    assert tschema.validate(dict(events[1], klass="urgent"), schema)
    # ids and ranks are scenario-scoped and sequential
    reqs = [e for e in events if e["event"] == "request"]
    assert [e["id"] for e in reqs] == \
        [f"alpha_stream-{i + 1:05d}" for i in range(len(reqs))]


def test_composed_scenarios_leave_each_stream_untouched(tmp_path):
    """Scenario A's journal lines are byte-identical whether A runs alone
    or composed with B on the same timeline."""
    a = load_scenario(_write(tmp_path, "a.yml", SCN_A))
    b = load_scenario(_write(tmp_path, "b.yml", SCN_B))
    solo = [json.dumps(e, sort_keys=True) for e in offered_events(a)]
    composed = sorted(
        (e for s in (a, b) for e in offered_events(s)),
        key=lambda e: (e["t"], e["scenario"], e["seq"]))
    from_composed = [json.dumps(e, sort_keys=True) for e in composed
                     if e["scenario"] == "alpha_stream"]
    assert from_composed == solo
    assert any(e["scenario"] == "beta_stream" for e in composed)


def test_write_tenant_table_scales_rates_only(tmp_path):
    import yaml
    a = load_scenario(_write(tmp_path, "a.yml", SCN_A))
    out = tmp_path / "tenants.yml"
    write_tenant_table([a], str(out), 40.0)
    doc = yaml.safe_load(out.read_text())
    t = doc["tenants"]["alpha"]
    assert t["rate_rps"] == pytest.approx(400.0)  # 10 virtual x 40
    assert t["burst"] == 40 and t["max_inflight"] == 32  # counts pass
    assert t["key"] == "alpha-k" and t["priority"] == "high"


def test_synthesize_corpus_items_distinct_and_stable(tmp_path):
    a = load_scenario(_write(tmp_path, "a.yml", SCN_A))
    c1 = synthesize_corpus(str(tmp_path / "corpus"), [a])
    c2 = synthesize_corpus(str(tmp_path / "corpus"), [a])
    assert c1 == c2 and len(c1) == 5
    blobs = {Path(p).read_bytes() for p in c1.values()}
    assert len(blobs) == 5  # content-addressed planes see 5 items
    jc = jloadgen.synthesize_corpus(str(tmp_path / "jcorpus"), [a])
    assert {k: Path(p).read_bytes() for k, p in jc.items()} == \
        {k: Path(p).read_bytes() for k, p in c1.items()}


# -- satellite: expired requests count against SLO attainment -----------------

def _make_loop(tmp_path, **over):
    from video_features_tpu_torch.config import load_config, sanity_check
    spool = tmp_path / "spool"
    cfg = load_config("resnet", dict({
        "model_name": "resnet18", "device": "cpu",
        "allow_random_weights": True, "on_extraction": "save_numpy",
        "extraction_total": 6, "batch_size": 8, "cache": False,
        "spool_dir": str(spool), "serve_poll_interval_s": 0.05,
        "metrics_interval_s": 1, "serve_slo_s": 60.0,
        "output_path": str(tmp_path / "out"),
        "tmp_path": str(tmp_path / "tmp")}, **over))
    sanity_check(cfg, require_videos=False)
    return serve.ServeLoop(cfg, out_root=str(tmp_path / "out")), str(spool)


def test_expired_request_is_an_slo_violation(tmp_path):
    """A deadline-expired request is answered and violated for
    attainment."""
    import os
    loop, spool = _make_loop(tmp_path)
    loop._run_one_video = lambda v: {"resnet": "done"}
    rid = serve.submit_request(spool, ["/v.mp4"], request_id="t1-exp",
                               deadline=time.time() - 0.1)
    src = Path(spool) / "requests" / f"{rid}.json"
    dst = Path(loop.claim_dir) / f"{rid}.json"
    os.rename(src, dst)
    loop._process(str(dst))
    assert serve.read_terminal(spool, rid)["status"] == "deadline_exceeded"
    with loop._state_lock:
        assert loop._answered == 1
        assert loop._slo_violations == 1
    hb_slo = loop._serve_section()["slo"]
    assert hb_slo["requests"] == 1 and hb_slo["violations"] == 1
    assert hb_slo["attainment_pct"] == 0.0
    loop.recorder.close()


# -- satellite: Retry-After includes fair-share queue backlog -----------------

TENANTS_YML = """
tenants:
  alpha:
    key: alpha-k
    rate_rps: 100
    burst: 100
    max_inflight: 8
    priority: high
  beta:
    key: beta-k
    rate_rps: 0.5
    burst: 1
    max_inflight: 2
    priority: low
"""


def test_retry_after_includes_queue_backlog(tmp_path):
    """Under backlog the 429's Retry-After grows by the class's
    weighted-fair-share drain estimate, not only the token refill."""
    (tmp_path / "tenants.yml").write_text(TENANTS_YML)
    g = GatewayServer({"spool_dir": str(tmp_path / "spool"),
                       "gateway_tenants": str(tmp_path / "tenants.yml"),
                       "gateway_poll_interval_s": 0.25,
                       "gateway_spool_bound": 64})
    try:
        beta = g.tenants["beta-k"]
        assert g._backlog_wait_s("low") == 0.0
        code, _body, _h = g.admit(beta, ["/v.mp4"], None)
        assert code == 202  # burst=1 consumed; next is a rate-429
        # 10 high + 128 more low queued at the edge: low's share of the
        # 64-per-tick budget is 1/(4+1) -> 12.8, so ~10 ticks x 0.25 s
        with g._lock:
            g._queues.setdefault("high", deque()).extend(
                {"id": f"h{i}"} for i in range(10))
            g._queues.setdefault("low", deque()).extend(
                {"id": f"l{i}"} for i in range(128))
        assert g._backlog_wait_s("low") == pytest.approx(2.52, rel=0.05)
        code, body, hdrs = g.admit(beta, ["/v.mp4"], None)
        assert code == 429
        assert int(hdrs["Retry-After"]) >= 4
        assert float(body["retry_after_s"]) >= 4
    finally:
        g.httpd.server_close()
        g.recorder.close()


# -- satellite: retained history carries per-tenant attainment ----------------

def test_history_sample_carries_tenant_attainment():
    from video_features_tpu_torch.telemetry.history import \
        sample_from_heartbeat
    hb = {"time": 123.0, "host_id": "h", "run_id": "r",
          "serve": {"tenants": {
              "alpha": {"requests": 20, "violations": 1, "rejects": 0},
              "beta": {"requests": 0, "violations": 0, "rejects": 2}}}}
    s = sample_from_heartbeat(hb)
    assert s["tenants"]["alpha"] == {"requests": 20, "violations": 1,
                                     "attainment_pct": 95.0}
    assert s["tenants"]["beta"]["attainment_pct"] is None


# -- the end-to-end drill -----------------------------------------------------

@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """One drill of ``SCN_A`` over real HTTP: the port's gateway in front
    of the port's ``ServeLoop`` whose video step is a 2 ms sleep."""
    tmp_path = tmp_path_factory.mktemp("drill")
    spec = load_scenario(_write(tmp_path, "a.yml", SCN_A))
    spool = tmp_path / "spool"
    write_tenant_table([spec], str(tmp_path / "tenants.yml"),
                       spec["speedup"])
    loop, _sp = _make_loop(tmp_path, serve_poll_interval_s=0.02)
    loop._run_one_video = lambda v: time.sleep(0.002) or {"resnet": "done"}
    t = threading.Thread(target=loop.run, daemon=True)
    t.start()
    gw = GatewayServer({"spool_dir": str(spool),
                        "gateway_tenants": str(tmp_path / "tenants.yml"),
                        "gateway_poll_interval_s": 0.05,
                        "metrics_interval_s": 1}).start()
    try:
        corpus = synthesize_corpus(str(tmp_path / "corpus"), [spec])
        runner = DrillRunner(
            [spec], str(spool), f"http://127.0.0.1:{gw.port}",
            corpus=corpus, audit_root=str(tmp_path), host_id="lg-e2e",
            drain_timeout_s=WAIT_S, http_timeout_s=WAIT_S)
        report = runner.run()
    finally:
        gw.stop()
        loop.stop()
        t.join(timeout=WAIT_S)
    assert not t.is_alive()
    return tmp_path, spec, runner, report


def test_drill_end_to_end_verdict_artifact_and_fleet_render(drill):
    tmp_path, spec, _runner, report = drill
    spool = tmp_path / "spool"
    art = json.loads((spool / "_scenario.json").read_text())
    assert tschema.validate(art, _schema("scenario.schema.json")) == []
    assert set(art) == set(loadgen.SCENARIO_FIELDS)
    assert art == report
    assert art["verdict"] == "PASS", art["objectives"]
    assert art["audit"]["pass"] is True

    journal = list(read_jsonl(spool / "_loadgen_lg-e2e.jsonl"))
    offered = sum(1 for r in journal if r.get("event") == "request")
    assert art["offered"] == offered > 0
    assert art["admitted"] + art["rejected"] + art["shed"] \
        + art["errors"] == offered
    assert art["admitted"] == art["completed"] + art["expired"]
    assert art["scenarios"][0]["offered"] == offered
    assert art["latency"]["wait"]["p95"] is not None

    assert len(art["curve"]) == spec["curve_windows"]
    assert art["curve"][-1]["t1"] == spec["duration_s"]
    vals = [w["tenants"].get("alpha", {}).get("attainment_pct")
            for w in art["curve"]]
    assert any(v is not None for v in vals)

    from video_features_tpu_torch.fleet_report import (aggregate,
                                                       build_prom_dump,
                                                       render)
    agg = aggregate(str(spool))
    assert any(s.get("scenario") == "alpha_stream"
               for s in agg["scenarios"])
    text = "\n".join(render(agg))
    assert "== scenarios ==" in text and "curve=" in text
    names = {s["name"] for s in build_prom_dump(agg)["series"]}
    assert {"vft_scenario_pass", "vft_scenario_offered",
            "vft_scenario_attainment_pct"} <= names

    from video_features_tpu_torch.audit import audit_run
    ok, violations, _notes = audit_run(str(tmp_path),
                                       expect_complete=True)
    assert ok, "\n".join(violations)


def test_build_report_and_audit_match_jax_on_the_drill(drill):
    """The exit join of both packages over the same recorded tree (the
    same specs, outcomes and clock) gives the same verdict artifact, and
    the two audits the same verdict and violations."""
    from video_features_tpu.audit import audit_run as jaudit_run
    from video_features_tpu_torch.audit import audit_run
    tmp_path, spec, runner, _report = drill
    twin = jloadgen.DrillRunner(
        [spec], runner.spool_dir, runner.base_url, corpus=runner.corpus,
        audit_root=runner.audit_root, host_id=runner.host_id)
    twin.outcomes = json.loads(json.dumps(runner.outcomes))
    now = 1_700_000_000.0
    assert runner.build_report(now=now) == twin.build_report(now=now)
    got = audit_run(str(tmp_path), expect_complete=True)
    want = jaudit_run(str(tmp_path), expect_complete=True)
    assert got[:2] == want[:2]
    assert got[0] is True


def _tampered_tree(tmp_path, package):
    spool = tmp_path / "spool"
    for d in ("requests", "claimed", "done", "expired", "inbox"):
        (spool / d).mkdir(parents=True)
    tb = {"offered": 2, "admitted": 1, "completed": 1, "expired": 0,
          "rejected": 1, "shed": 0, "errors": 0, "violations": 0,
          "attainment_pct": 100.0}
    art = {"schema": "vft.scenario/1", "time": 1.0, "scenario": "s",
           "scenarios": [{"name": "s", "seed": 1, "spec_sha": "x"}],
           "clock": "virtual", "speedup": 40.0, "duration_s": 10.0,
           "slo_s": None, "host_id": "h", "journal": "_loadgen_h.jsonl",
           "offered": 2, "admitted": 1, "completed": 1, "expired": 0,
           "rejected": 1, "shed": 0, "errors": 0, "tenants": {"a": tb},
           "latency": {"unit": "virtual_s",
                       "wait": {"p50": None, "p95": None, "p99": None},
                       "service": {"p50": None, "p95": None,
                                   "p99": None}},
           "curve": [], "history": None,
           "alerts": {"page": 0, "ticket": 0},
           "audit": {"pass": False, "violations": 3},
           "objectives": [], "verdict": "PASS"}
    package.write_json_atomic(spool / "_scenario.json", art)
    # the journal records ONE request event, not the claimed two
    package.append_jsonl(str(spool / "_loadgen_h.jsonl"),
                         {"schema": "vft.loadgen_event/1", "scenario": "s",
                          "seed": 1, "seq": 1, "t": 0.1, "event": "request",
                          "id": "s-00001", "tenant": "a", "klass": "high",
                          "videos": ["k"], "timeout_s": None,
                          "slow_bps": None})


def test_audit_flags_inconsistent_scenario_artifact(tmp_path):
    """Invariant 12: an artifact claiming traffic the journal does not
    record, or PASS over a failed audit, fails the audit."""
    from video_features_tpu_torch.audit import audit_run
    from video_features_tpu_torch.telemetry import jsonl
    _tampered_tree(tmp_path, jsonl)
    ok, violations, _ = audit_run(str(tmp_path))
    assert not ok
    assert any("records 1 request event" in v for v in violations)
    assert any("PASS over a recorded audit failure" in v
               for v in violations)


def test_audit_of_the_tampered_artifact_matches_jax(tmp_path):
    from video_features_tpu.audit import audit_run as jaudit_run
    from video_features_tpu_torch.audit import audit_run
    from video_features_tpu_torch.telemetry import jsonl
    _tampered_tree(tmp_path, jsonl)
    assert audit_run(str(tmp_path))[:2] == jaudit_run(str(tmp_path))[:2]
