"""The port's warm server (``serve.py``) against the JAX package's.

- The cases of the JAX ``tests/test_serve.py`` on the port, driven in
  process (a thread around ``serve_main``, bounded by
  ``serve_max_requests``): the spool roundtrip with a feature-cache hit on
  a byte-identical copy and no kernel build after the first request, the
  heartbeat's ``serve`` section as readiness and the SLO block, request
  correlation in spans, digests and the trace, admission control past
  ``serve_max_pending``, the bounded SLO accounting, the report's serve
  line with ``--fail-on-slo``, and the reclaim of a dead server's claims;
- the protocol across packages: requests submitted by the JAX
  ``serve.submit_request`` are answered by the port's ``ServeLoop``, and
  JAX's ``read_response``/``server_state`` read the answers; JAX's
  ``audit.audit_run`` finds no violation in the port's served tree, and
  the port's ``audit_run`` gives the same verdict, violations and notes;
- the served features equal the port's ``cli.main`` on the same video bit
  for bit, and JAX's served features within the value tier (atol 1e-2) on
  one seeded resnet18 checkpoint;
- the ``spool.claim`` and ``spool.respond`` sites, and SIGTERM -> 143 on a
  real server process.
"""
import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu_torch import serve
from video_features_tpu_torch.utils import inject

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import torch

    from video_features_tpu_torch.models.resnet import ResNet
    from video_features_tpu_torch.weights.bridge import seeded_init_
    path = tmp_path_factory.mktemp("serve_ckpt") / "resnet18.pt"
    torch.save(seeded_init_(ResNet("resnet18"), 5).state_dict(), path)
    return path


def _base_args(tmp_path, sample_video, ckpt, n_copies=2, spool="spool",
               out="out"):
    vids = []
    for i in range(n_copies):
        dst = tmp_path / f"clip{i}.mp4"
        if not dst.exists():
            shutil.copy(sample_video, dst)
        vids.append(str(dst))
    argv = ["feature_type=resnet", "model_name=resnet18", "device=cpu",
            f"weights_path={ckpt}", "on_extraction=save_numpy",
            "extraction_total=4", "batch_size=8",
            "cache=true", f"cache_dir={tmp_path / 'cache'}",
            f"spool_dir={tmp_path / spool}", "serve_poll_interval_s=0.05",
            "metrics_interval_s=0.5", "serve_idle_exit_s=120",
            f"output_path={tmp_path / out}",
            f"tmp_path={tmp_path / 'tmp'}"]
    return argv, str(tmp_path / spool), vids


def _serve_thread(main, argv):
    t = threading.Thread(target=main, args=(argv,), daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def served(tmp_path_factory, sample_video, ckpt):
    """One port server session of two requests, both submitted through
    the JAX package's client: the sample, then a byte-identical copy (a
    feature-cache hit), with ``health`` and ``trace`` on."""
    from video_features_tpu import serve as jserve
    tmp = tmp_path_factory.mktemp("served")
    argv, spool, vids = _base_args(tmp, sample_video, ckpt)
    absent = jserve.server_state(spool)
    t = _serve_thread(serve.serve_main, argv + [
        "serve_max_requests=2", "health=true", "trace=true"])
    r1 = jserve.submit_request(spool, [vids[0]])
    resp1 = jserve.wait_response(spool, r1, timeout_s=240)
    mid_state = jserve.server_state(spool)
    r2 = jserve.submit_request(spool, [vids[1]])
    resp2 = jserve.wait_response(spool, r2, timeout_s=240)
    t.join(timeout=120)
    # both readers at one instant: each reports the heartbeat's age from
    # its own time.time(), and two calls a millisecond apart differ
    now = time.time()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: now)
        final_state = jserve.server_state(spool)
        port_final_state = serve.server_state(spool)
    return dict(tmp=tmp, argv=argv, spool=spool, vids=vids, r1=r1, r2=r2,
                resp1=resp1, resp2=resp2, absent=absent,
                mid_state=mid_state, alive=t.is_alive(),
                final_state=final_state, port_final_state=port_final_state)


def test_serve_roundtrip_warm_and_cache_hit(served):
    assert not served["alive"], "bounded server failed to exit"
    assert served["absent"] == {"state": "absent"}
    resp1, resp2 = served["resp1"], served["resp2"]
    vids = served["vids"]
    assert resp1["status"] == "done", resp1
    assert resp1["schema"] == "vft.serve_response/1"
    assert resp1["videos"][vids[0]] == {"resnet": "done"}
    out_root = Path(resp1["output_path"])
    assert resp1["latency_s"] > 0 and resp1["wait_s"] >= 0
    assert served["mid_state"]["state"] in ("ready", "unknown")
    assert resp2["status"] == "done", resp2
    # no kernel build after request 1 (on the CPU none at all)
    assert resp2["compile_cache"] == {"hits": 0, "misses": 0}
    a = np.load(next(out_root.rglob(f"{Path(vids[0]).stem}_resnet.npy")))
    b = np.load(next(out_root.rglob(f"{Path(vids[1]).stem}_resnet.npy")))
    np.testing.assert_array_equal(a, b)
    assert served["final_state"]["state"] == "exited"
    assert served["final_state"] == served["port_final_state"]
    spool = Path(served["spool"])
    hb = json.loads(next(spool.glob("_heartbeat_*.json")).read_text())
    assert hb["cache"]["hits"] == {"resnet": 1}
    assert hb["serve"]["requests"]["done"] == 2
    slo = hb["serve"]["slo"]
    assert slo["slo_s"] is None and slo["requests"] == 2
    assert slo["violations"] == 0 and slo["attainment_pct"] == 100.0
    assert slo["service"]["p95"] is not None
    assert hb["final"] and hb["serve"]["active_requests"] == []


def test_request_correlation_end_to_end(served):
    r1, r2 = served["r1"], served["r2"]
    spool = Path(served["spool"])
    out_root = Path(served["resp1"]["output_path"])
    spans = [json.loads(line) for line in
             (spool / "_telemetry.jsonl").read_text().splitlines()]
    assert {s["request_id"] for s in spans} == {r1, r2}
    health = [json.loads(line) for line in
              next(out_root.rglob("_health.jsonl")).read_text()
              .splitlines()]
    assert {h["request_id"] for h in health} == {r1, r2}
    trace_doc = json.loads(next(spool.glob("_trace_*.json")).read_text())
    tagged = {e["args"].get("id") or e["args"].get("request")
              for e in trace_doc["traceEvents"]
              if isinstance(e.get("args"), dict)
              and e["name"] in ("serve.request", "video_attempt")}
    assert {r1, r2} <= tagged
    from video_features_tpu_torch import fleet_report
    kinds = {h.split()[0]
             for h in fleet_report.find_request(str(served["tmp"]), r1)}
    assert {"span", "health", "trace", "spool"} <= kinds, kinds


def test_jax_readers_read_the_port_spool(served):
    """JAX's ``read_response``, ``read_terminal`` and ``server_state``
    read what the port's server wrote as the port's do."""
    from video_features_tpu import serve as jserve
    for rid in (served["r1"], served["r2"]):
        assert jserve.read_response(served["spool"], rid) == \
            serve.read_response(served["spool"], rid)
        assert jserve.read_terminal(served["spool"], rid)["status"] == \
            "done"
    assert jserve.spool_paths(served["spool"]) == \
        serve.spool_paths(served["spool"])


def test_jax_audit_finds_no_violation_in_the_served_tree(served):
    """The root above the spool, the outputs and the feature cache: the
    spans' artifacts, the spool's done/expired exclusivity, the cache
    entries; the port's audit gives the same verdict, violations and
    notes."""
    from video_features_tpu import audit
    from video_features_tpu_torch import audit as taudit
    ok, violations, notes = audit.audit_run(str(served["tmp"]))
    assert ok, violations
    assert taudit.audit_run(str(served["tmp"])) == (ok, violations, notes)


def test_served_features_equal_cli_and_jax_value_tier(served, sample_video,
                                                      ckpt, tmp_path):
    """Request 1's features equal the port's ``cli.main`` on the same video
    bit for bit, and the JAX server's on the same checkpoint within the
    value tier."""
    from video_features_tpu import serve as jserve
    from video_features_tpu_torch.cli import main as tmain
    vid = served["vids"][0]
    stem = Path(vid).stem
    argv = [a for a in served["argv"]
            if not a.startswith(("spool_dir=", "serve_", "output_path=",
                                 "cache"))]
    with contextlib.redirect_stdout(io.StringIO()):
        tmain(argv + [f"output_path={tmp_path / 'cli'}",
                      f"video_paths={vid}"])
    cli_dir = tmp_path / "cli" / "resnet" / "resnet18"
    srv_dir = Path(served["resp1"]["output_path"])
    keys = ("resnet", "fps", "timestamps_ms")
    for key in keys:
        assert (cli_dir / f"{stem}_{key}.npy").read_bytes() == \
            (srv_dir / f"{stem}_{key}.npy").read_bytes(), key
    jargv, jspool, _ = _base_args(tmp_path, sample_video, ckpt,
                                  spool="jspool", out="jout")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        t = _serve_thread(jserve.serve_main,
                          jargv + ["serve_max_requests=1", "cache=false"])
        rid = jserve.submit_request(jspool, [vid])
        resp = jserve.wait_response(jspool, rid, timeout_s=240)
        t.join(timeout=120)
    assert resp["status"] == "done", resp
    jdir = Path(resp["output_path"])
    for key in keys:
        np.testing.assert_allclose(
            np.load(srv_dir / f"{stem}_{key}.npy"),
            np.load(jdir / f"{stem}_{key}.npy"), atol=1e-2, rtol=0,
            err_msg=key)


def _loop(tmp_path, sample_video, ckpt, **over):
    from video_features_tpu_torch.config import (load_config, parse_dotlist,
                                                 sanity_check)
    argv, spool, vids = _base_args(tmp_path, sample_video, ckpt,
                                   n_copies=1)
    cfg = load_config("resnet", parse_dotlist(argv))
    cfg.cache = False
    for k, v in over.items():
        cfg[k] = v
    sanity_check(cfg, require_videos=False)
    return serve.ServeLoop(cfg, out_root=str(tmp_path / "out")), spool, vids


def test_admission_control_rejects_overflow(sample_video, ckpt, tmp_path):
    loop, spool, vids = _loop(tmp_path, sample_video, ckpt,
                              serve_max_pending=2)
    rids = [serve.submit_request(spool, [vids[0]]) for _ in range(5)]
    for i, rid in enumerate(rids):  # distinct arrival order
        t = time.time() - 10 + i
        os.utime(Path(spool, "requests", f"{rid}.json"), (t, t))
    loop._reject_overflow()
    rejected = [r for r in rids
                if (resp := serve.read_response(spool, r)) is not None
                and resp["status"] == "rejected"]
    assert set(rejected) == set(rids[2:])
    for rid in rejected:
        assert "serve_max_pending" in serve.read_response(spool,
                                                          rid)["error"]
    loop.recorder.close()


def test_slo_accounting_percentiles_violations_bounded(sample_video, ckpt,
                                                       tmp_path):
    loop, _, _ = _loop(tmp_path, sample_video, ckpt, serve_slo_s=1.0)
    slo = loop._serve_section()["slo"]
    assert slo == {"slo_s": 1.0, "requests": 0, "violations": 0,
                   "attainment_pct": None,
                   "queue_wait": {"p50": None, "p95": None, "p99": None},
                   "service": {"p50": None, "p95": None, "p99": None}}
    for _ in range(90):
        assert not loop._account_request(0.01, 0.1)
    for _ in range(10):
        assert loop._account_request(0.6, 0.9)
    slo = loop._serve_section()["slo"]
    assert slo["requests"] == 100 and slo["violations"] == 10
    assert slo["attainment_pct"] == 90.0
    assert slo["service"]["p50"] <= 0.25 and slo["service"]["p95"] >= 0.5
    assert slo["queue_wait"]["p50"] <= 0.025
    assert len(loop._recent) == 32
    reg = loop.recorder.registry
    assert reg.counter("vft_serve_slo_violations_total").value == 10
    # the same histogram snapshots give JAX's percentiles
    from video_features_tpu.telemetry.metrics import histogram_quantiles
    from video_features_tpu_torch.telemetry.metrics import LATENCY_BUCKETS
    snap = reg.histogram("vft_serve_service_seconds",
                         buckets=LATENCY_BUCKETS).snapshot()
    assert histogram_quantiles(snap) == slo["service"]
    loop.recorder.close()


def test_report_serve_line_and_fail_on_slo(tmp_path):
    from video_features_tpu_torch.telemetry import report
    from video_features_tpu_torch.telemetry.jsonl import write_json_atomic

    def hb(violations):
        return {"host_id": "srv-1", "time": time.time(),
                "interval_s": 30.0, "final": False, "videos_done": 5,
                "serve": {
                    "state": "ready", "pending": 1, "inflight": 2,
                    "requests": {"done": 20, "rejected": 1},
                    "slo": {"slo_s": 2.0, "requests": 20,
                            "violations": violations,
                            "attainment_pct": 100.0 - 5.0 * violations,
                            "queue_wait": {"p50": 0.01, "p95": 0.2,
                                           "p99": 0.3},
                            "service": {"p50": 0.5, "p95": 1.5,
                                        "p99": 1.9}}}}

    out = tmp_path / "spool"
    out.mkdir()
    write_json_atomic(out / "_heartbeat_srv-1.json", hb(3))
    text = "\n".join(report.render_heartbeats(
        [str(out / "_heartbeat_srv-1.json")], time.time()))
    assert "serve: ready" in text and "rejected=1" in text
    assert "slo: service p50/p95/p99=0.5/1.5/1.9s" in text
    assert "violations=3" in text and "attainment=85.0%" in text
    with contextlib.redirect_stdout(io.StringIO()):
        assert report.main([str(out), "--fail-on-slo"]) == 1
        write_json_atomic(out / "_heartbeat_srv-1.json", hb(0))
        assert report.main([str(out), "--fail-on-slo"]) == 0


def test_dead_server_claims_reclaimed(sample_video, ckpt, tmp_path):
    from video_features_tpu_torch.telemetry.jsonl import write_json_atomic
    loop, spool, vids = _loop(tmp_path, sample_video, ckpt,
                              serve_max_requests=2)
    claimed = Path(spool) / "claimed"

    def orphan(rid, owner=None):
        src = Path(spool) / "requests" / f"{rid}.json"
        dst = (claimed / f"{rid}.json" if owner is None
               else claimed / owner / f"{rid}.json")
        dst.parent.mkdir(parents=True, exist_ok=True)
        os.rename(src, dst)
        return dst

    now = time.time()
    orphan(serve.submit_request(spool, [vids[0]], request_id="deadclaim"),
           owner="deadhost-1")
    write_json_atomic(Path(spool) / "_heartbeat_deadhost-1.json",
                      {"host_id": "deadhost-1", "time": now - 100.0,
                       "interval_s": 1.0, "final": False})
    orphan(serve.submit_request(spool, [vids[0]], request_id="answered"),
           owner="deadhost-1")
    write_json_atomic(Path(spool) / "done" / "answered.json",
                      {"schema": serve.RESPONSE_SCHEMA, "id": "answered",
                       "status": "done"})
    live = orphan(serve.submit_request(spool, [vids[0]],
                                       request_id="liveclaim"),
                  owner="livehost-1")
    write_json_atomic(Path(spool) / "_heartbeat_livehost-1.json",
                      {"host_id": "livehost-1", "time": now,
                       "interval_s": 30.0, "final": False})
    orphan(serve.submit_request(spool, [vids[0]], request_id="legacy"))
    assert loop._reclaim_orphans() == 2
    assert {p.stem for p in (Path(spool) / "requests").glob("*.json")} == \
        {"deadclaim", "legacy"}
    assert live.exists()
    assert not (claimed / "deadhost-1" / "answered.json").exists()
    assert loop._reclaim_orphans() == 0
    t = threading.Thread(target=loop.run, daemon=True)
    t.start()
    try:
        for rid in ("deadclaim", "legacy"):
            assert serve.wait_response(spool, rid,
                                       timeout_s=240)["status"] == "done"
    finally:
        loop.stop()
        t.join(timeout=60)
    assert not t.is_alive()


@pytest.mark.parametrize("spec,site", [
    ("seed=1;spool.claim=eio@n1", "spool.claim"),
    ("seed=1;spool.respond=drop@n1", "spool.respond")])
def test_spool_sites_fire_and_the_request_is_answered(sample_video, ckpt,
                                                      tmp_path, spec, site):
    """``spool.claim=eio`` fails the first claim like a lost race;
    ``spool.respond=drop`` loses the first response write, and the claim
    is requeued: either way the request is answered once, on a later
    pass."""
    loop, spool, vids = _loop(tmp_path, sample_video, ckpt,
                              serve_max_requests=2, serve_idle_exit_s=3)
    rid = serve.submit_request(spool, [vids[0]])
    plan = inject.arm_for_run(spec)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert loop.run() == 0
    finally:
        inject.disarm()
    assert f"{site}" in plan.summary()
    resp = serve.read_response(spool, rid)
    assert resp is not None and resp["status"] == "done", resp
    assert not list(Path(spool, "requests").glob("*.json"))
    hb = json.loads(next(Path(spool).glob("_heartbeat_*.json")).read_text())
    assert hb["serve"]["requests"]["done"] == 1


def test_sigterm_exits_143_with_a_final_heartbeat(tmp_path):
    """A real server process: ready, then SIGTERM drains and exits 143
    with a final heartbeat (``serve_idle_exit_s`` bounds it otherwise)."""
    spool = tmp_path / "spool"
    argv = [sys.executable, "-m", "video_features_tpu_torch", "serve",
            "feature_type=resnet", "model_name=resnet18", "device=cpu",
            "allow_random_weights=true", f"spool_dir={spool}",
            "metrics_interval_s=0.5", "serve_poll_interval_s=0.05",
            "serve_idle_exit_s=120", f"output_path={tmp_path / 'out'}",
            f"tmp_path={tmp_path / 'tmp'}"]
    import torch
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        while serve.server_state(str(spool)).get("state") != "ready":
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            assert time.monotonic() < deadline
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert serve.server_state(str(spool))["state"] == "exited"
