"""The port's HTTP gateway (``gateway.py``) against the JAX package's.

- Units, each held against JAX on the same inputs and clock: the tenant
  table and its validation, ``validate_gateway_args``, the token bucket,
  the weighted fair-share release order;
- a scripted HTTP sequence (401, 429 with ``Retry-After``, 202, 403, the
  upload and its dedup, 400 on a corrupted upload, 503 on a dead backend,
  the poll of an expired request) gets the same status codes and JSON keys
  from both gateways, each on an ephemeral port with no backend;
- deadlines against the port's ``ServeLoop`` with the video step stubbed:
  expiry while queued (cancelled at claim, no video run), mid-request
  (partial results, an ``expired/`` record and never a ``done/`` one), and
  duration-relative deadlines;
- the gateway's own sweep expires a spooled request nobody serves, and
  JAX's ``audit.audit_run`` passes the tree, as the port's does, word for
  word; SIGTERM's drain flushes
  accepted requests into the spool;
- the ``gateway.read`` and ``gateway.spool_submit`` sites.
"""
import hashlib
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from video_features_tpu import gateway as jgateway
from video_features_tpu_torch import gateway, serve
from video_features_tpu_torch.telemetry.jsonl import write_json_atomic
from video_features_tpu_torch.utils import inject

PACKAGES = {"port": gateway, "jax": jgateway}

TENANTS_YML = """
tenants:
  alpha:
    key: alpha-k
    rate_rps: 100
    burst: 100
    max_inflight: 2
    priority: high
  beta:
    key: beta-k
    rate_rps: 0.5
    burst: 1
    max_inflight: 2
    priority: low
  gamma:
    key: gamma-k
"""


def _call(base, method, path, data=None, key=None, headers=None):
    req = urllib.request.Request(base + path, data=data, method=method)
    if key:
        req.add_header("X-API-Key", key)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _start(mod, tmp_path, **over):
    tmp_path.mkdir(parents=True, exist_ok=True)
    ty = tmp_path / "tenants.yml"
    ty.write_text(TENANTS_YML)
    args = {"spool_dir": str(tmp_path / "spool"),
            "gateway_tenants": str(ty), "gateway_poll_interval_s": 0.05,
            "gateway_expire_grace_s": 0.5, "metrics_interval_s": 1}
    args.update(over)
    g = mod.GatewayServer(args).start()
    return g, f"http://127.0.0.1:{g.port}"


@pytest.fixture
def gw(tmp_path):
    g, base = _start(gateway, tmp_path)
    yield g, base
    g.stop()


# -- units against JAX ---------------------------------------------------------

def _table(mod, path):
    return {k: (t.name, t.key, t.rate_rps, t.burst, t.max_inflight,
                t.priority)
            for k, t in mod.load_tenant_table(path).items()}


def test_tenant_table_validation(tmp_path):
    p = tmp_path / "tenants.yml"
    p.write_text(TENANTS_YML)
    table = gateway.load_tenant_table(str(p))
    assert {t.name for t in table.values()} == {"alpha", "beta", "gamma"}
    assert table["gamma-k"].priority == "normal"  # the defaults
    assert table["alpha-k"].priority == "high"
    assert _table(gateway, str(p)) == _table(jgateway, str(p))
    assert _table(gateway, None) == _table(jgateway, None)
    assert gateway.load_tenant_table(None)[None].name == "anon"

    def bad(yml, needle):
        p.write_text(yml)
        for mod in PACKAGES.values():
            with pytest.raises(ValueError, match=needle):
                mod.load_tenant_table(str(p))

    bad("tenants: {}", "at least one tenant")
    bad("tenants:\n  has-dash:\n    key: k\n", r"\[a-z0-9_\]\+")
    bad("tenants:\n  a:\n    priority: high\n", "needs a string 'key'")
    bad("tenants:\n  a:\n    key: k\n  b:\n    key: k\n", "duplicates")
    bad("tenants:\n  a:\n    key: k\n    priority: urgent\n", "priority")
    bad("tenants:\n  a:\n    key: k\n    rate_rps: 0\n", "rate_rps")
    bad("tenants:\n  a:\n    key: k\n    max_inflight: 0\n",
        "max_inflight")


@pytest.mark.parametrize("args,needle", [
    ({"gateway_port": 70000}, "gateway_port"),
    ({"gateway_port": "80"}, "gateway_port"),
    ({"gateway_host": 5}, "gateway_host"),
    ({"gateway_max_queued": 0}, "gateway_max_queued"),
    ({"gateway_spool_bound": 0}, "gateway_spool_bound"),
    ({"gateway_poll_interval_s": 0}, "gateway_poll_interval_s"),
    ({"gateway_default_timeout_s": -1}, "gateway_default_timeout_s"),
    ({"gateway_tenants": 3}, "gateway_tenants"),
    ({"gateway_port": 0, "gateway_max_body_mb": 8}, None)])
def test_validate_gateway_args_equals_jax(args, needle):
    from video_features_tpu_torch import config as tconfig
    for mod in PACKAGES.values():
        if needle is None:
            mod.validate_gateway_args(args)
        else:
            with pytest.raises(ValueError, match=needle):
                mod.validate_gateway_args(args)
    # the port's sanity_check runs it on every config with gateway_* keys
    cfg = tconfig.load_config("resnet", dict(
        args, device="cpu", output_path="o", tmp_path="t",
        video_paths="a.mp4"))
    if needle is None:
        tconfig.sanity_check(cfg)
    else:
        with pytest.raises(ValueError, match=needle):
            tconfig.sanity_check(cfg)


def test_token_bucket_deterministic_retry_after():
    got = {}
    for name, mod in PACKAGES.items():
        clock = [0.0]
        b = mod.TokenBucket(rate_rps=2.0, burst=3, clock=lambda: clock[0])
        seq = [b.try_take() for _ in range(4)]
        clock[0] += 0.5
        seq += [b.try_take(), b.try_take()]
        clock[0] += 100.0
        seq += [b.try_take() for _ in range(4)]
        clock[0] += 0.25
        seq.append(b.try_take(0.25))
        got[name] = seq
    assert got["port"] == got["jax"]
    seq = got["port"]
    assert [ok for ok, _ in seq[:4]] == [True, True, True, False]
    assert seq[3][1] == pytest.approx(0.5)
    assert seq[4] == (True, 0.0) and not seq[5][0]
    assert [ok for ok, _ in seq[6:10]] == [True, True, True, False]


def _pick_order(mod, tmp_path):
    g = mod.GatewayServer({"spool_dir": str(tmp_path / "spool")})
    t = mod.Tenant("t", None, **mod.TENANT_DEFAULTS)
    for klass in ("high", "normal", "low"):
        for i in range(7):
            p = mod._Pending(f"{klass}{i}", t, ["v"], None)
            p.klass = klass
            g._queues[klass].append(p)
    order = [g._pick_class() for _ in range(7)]
    for klass in order:
        g._queues[klass].popleft()
    order += [g._pick_class() for _ in range(7)]
    g.httpd.server_close()
    g.recorder.close()
    return order


def test_weighted_fair_share_release_order(tmp_path):
    order = _pick_order(gateway, tmp_path / "p")
    assert order[:7] == ["high", "normal", "high", "low", "high", "normal",
                         "high"]
    assert order[7:].count("high") == 4
    assert order == _pick_order(jgateway, tmp_path / "j")


# -- HTTP: one scripted sequence, both gateways ----------------------------------

def _script(mod, tmp_path):
    """The sequence; returns [(step, status, sorted body keys,
    Retry-After present)]."""
    g, base = _start(mod, tmp_path)
    out = []

    def rec(step, res):
        st, body, headers = res
        out.append((step, st, sorted(body), "Retry-After" in headers))
        return res

    try:
        body = json.dumps({"video_paths": ["/v.mp4"],
                           "timeout_s": 60}).encode()
        rec("no key", _call(base, "POST", "/v1/extract", body))
        rec("bad key", _call(base, "POST", "/v1/extract", body, key="x"))
        rec("beta 1", _call(base, "POST", "/v1/extract", body,
                            key="beta-k"))
        _, rej, h = rec("beta rate", _call(base, "POST", "/v1/extract",
                                           body, key="beta-k"))
        assert h["Retry-After"] == "2" and rej["retry_after_s"] == 2
        rids = [rec("alpha", _call(base, "POST", "/v1/extract", body,
                                   key="alpha-k"))[1]["id"]
                for _ in range(2)]
        rec("alpha inflight", _call(base, "POST", "/v1/extract", body,
                                    key="alpha-k"))
        rec("isolation", _call(base, "GET", f"/v1/requests/{rids[0]}",
                               key="beta-k"))
        rec("poll", _call(base, "GET", f"/v1/requests/{rids[0]}",
                          key="alpha-k"))
        rec("unknown", _call(base, "GET", "/v1/requests/alpha-nosuch",
                             key="alpha-k"))
        rec("bad json", _call(base, "POST", "/v1/extract", b"{",
                              key="alpha-k"))
        rec("no videos", _call(base, "POST", "/v1/extract", b"{}",
                               key="alpha-k"))
        data = b"not really mp4 bytes, but bytes"
        rec("upload", _call(base, "POST", "/v1/upload?name=clip.mp4", data,
                            key="alpha-k"))
        rec("upload again", _call(base, "POST", "/v1/upload?name=clip.mp4",
                                  data, key="alpha-k"))
        rec("corrupt upload", _call(
            base, "POST", "/v1/upload?name=clip.mp4", b"corrupted",
            key="alpha-k",
            headers={"X-Content-SHA256": hashlib.sha256(data).hexdigest()}))
        rec("healthz", _call(base, "GET", "/healthz"))
        rec("no route", _call(base, "GET", "/nope"))
        # the only server on the spool wrote a final heartbeat: shed
        write_json_atomic(Path(g.spool_dir) / "_heartbeat_srv-1.json",
                          {"host_id": "srv-1", "time": time.time(),
                           "interval_s": 1.0, "final": True,
                           "serve": {"state": "exited"}})
        for p in Path(g.spool_dir, "requests").glob("*.json"):
            p.unlink()  # nothing backlogged: the shed is the backend's
        rec("shed", _call(base, "POST", "/v1/extract", json.dumps(
            {"video_paths": ["/v.mp4"]}).encode(), key="gamma-k"))
        section = g._gateway_section()
        tallies = {t: {k: v for k, v in s.items()}
                   for t, s in section["tenants"].items()}
    finally:
        g.stop()
    return out, tallies


def test_scripted_http_sequence_equals_jax(tmp_path):
    port, port_tallies = _script(gateway, tmp_path / "p")
    jax, jax_tallies = _script(jgateway, tmp_path / "j")
    assert port == jax
    assert port_tallies == jax_tallies
    codes = [st for _, st, _, _ in port]
    assert codes == [401, 401, 202, 429, 202, 202, 429, 403, 202, 404,
                     400, 400, 201, 200, 400, 200, 404, 503]
    assert port_tallies["gamma"]["shed"] == 1


def test_upload_content_addressed_idempotent(gw):
    g, base = gw
    data = b"some uploaded bytes"
    sha = hashlib.sha256(data).hexdigest()
    st1, up1, _ = _call(base, "POST", "/v1/upload?name=clip.mp4", data,
                        key="alpha-k")
    assert st1 == 201 and up1["dedup"] is False and up1["sha256"] == sha
    assert Path(up1["path"]).read_bytes() == data
    assert Path(up1["path"]).name == f"{sha[:16]}.mp4"
    st2, up2, _ = _call(base, "POST", "/v1/upload?name=clip.mp4", data,
                        key="alpha-k")
    assert st2 == 200 and up2["dedup"] is True
    assert up2["path"] == up1["path"]
    assert len(list(Path(g.inbox_dir).iterdir())) == 1
    events = [json.loads(ln) for ln in
              Path(g.journal_path).read_text().splitlines()]
    assert [e.get("dedup") for e in events if e["event"] == "upload"] == \
        [False, True]


def test_metrics_and_healthz(gw):
    g, base = gw
    _call(base, "POST", "/v1/extract", b"{}", key="alpha-k")
    req = urllib.request.Request(base + "/metrics")
    with urllib.request.urlopen(req, timeout=30) as r:
        text = r.read().decode()
    assert r.status == 200 and "# TYPE" in text
    st, b, _ = _call(base, "GET", "/healthz")
    assert st == 200 and b["gateway"]["state"] == "ready"
    assert b["backend"] == {"state": "absent"}
    assert b["gateway"]["port"] == g.port


# -- deadlines (the port's ServeLoop, video step stubbed) ----------------------

def _make_loop(tmp_path):
    from video_features_tpu_torch.config import load_config, sanity_check
    spool = tmp_path / "spool"
    cfg = load_config("resnet", {
        "model_name": "resnet18", "device": "cpu",
        "allow_random_weights": True, "on_extraction": "save_numpy",
        "extraction_total": 6, "batch_size": 8, "cache": False,
        "spool_dir": str(spool), "serve_poll_interval_s": 0.05,
        "metrics_interval_s": 1, "output_path": str(tmp_path / "out"),
        "tmp_path": str(tmp_path / "tmp")})
    sanity_check(cfg, require_videos=False)
    return serve.ServeLoop(cfg, out_root=str(tmp_path / "out")), str(spool)


def _claim(loop, spool, rid):
    src = Path(spool) / "requests" / f"{rid}.json"
    dst = Path(loop.claim_dir) / f"{rid}.json"
    os.rename(src, dst)
    return str(dst)


def test_deadline_expired_while_queued_cancelled_at_claim(tmp_path):
    loop, spool = _make_loop(tmp_path)
    calls = []
    loop._run_one_video = lambda v: calls.append(v) or {"resnet": "done"}
    rid = serve.submit_request(spool, ["/v.mp4"], request_id="t1-queuedexp",
                               deadline=time.time() - 0.1)
    loop._process(_claim(loop, spool, rid))
    assert calls == []
    assert serve.read_response(spool, rid) is None
    term = serve.read_terminal(spool, rid)
    assert term["status"] == "deadline_exceeded"
    assert term["expired_at"] == "claim" and term["processed"] == 0
    assert term["tenant"] == "t1"
    assert loop._tallies["deadline_exceeded"] == 1
    assert not list(Path(loop.claim_dir).glob("*.json"))
    assert loop._tenants["t1"] == {"requests": 1, "violations": 1,
                                   "rejects": 0}
    loop.recorder.close()


def test_deadline_expires_mid_request_partial_results(tmp_path):
    loop, spool = _make_loop(tmp_path)

    def slow_video(v):
        time.sleep(0.35)
        return {"resnet": "done"}

    loop._run_one_video = slow_video
    vids = [f"/v{i}.mp4" for i in range(4)]
    rid = serve.submit_request(spool, vids, request_id="t1-midexp",
                               deadline=time.time() + 0.5)
    loop._process(_claim(loop, spool, rid))
    term = serve.read_terminal(spool, rid)
    assert term["status"] == "deadline_exceeded"
    assert term["expired_at"] == "mid_request"
    assert 1 <= term["processed"] < len(vids)
    assert set(term["videos"]) == set(vids[:term["processed"]])
    assert serve.read_response(spool, rid) is None
    loop.recorder.close()


def test_deadlines_are_duration_relative_not_client_clock(tmp_path):
    g = gateway.GatewayServer({"spool_dir": str(tmp_path / "gspool"),
                               "gateway_poll_interval_s": 0.05})
    before = time.time()
    code, body, _ = g.admit(g.tenants[None], ["/v.mp4"], 60.0)
    assert code == 202 and body["id"].startswith("anon-")
    assert before + 59 <= body["deadline"] <= time.time() + 61
    g.httpd.server_close()
    g.recorder.close()
    loop, spool = _make_loop(tmp_path)
    loop._run_one_video = lambda v: {"resnet": "done"}
    rid = serve.submit_request(spool, ["/v.mp4"], request_id="t1-skew",
                               deadline=time.time() + 60)
    req_path = Path(spool) / "requests" / f"{rid}.json"
    req = json.loads(req_path.read_text())
    req["time"] = time.time() + 3 * 3600  # a skewed client clock
    write_json_atomic(req_path, req)
    loop._process(_claim(loop, spool, rid))
    resp = serve.read_response(spool, rid)
    assert resp["status"] == "done" and resp["wait_s"] == 0.0
    loop.recorder.close()


def test_gateway_expires_spooled_request_and_audits_clean(tmp_path):
    from video_features_tpu.audit import audit_run
    g = gateway.GatewayServer({"spool_dir": str(tmp_path / "spool"),
                               "gateway_poll_interval_s": 0.05,
                               "gateway_expire_grace_s": 0.5,
                               "metrics_interval_s": 1}).start()
    base = f"http://127.0.0.1:{g.port}"
    st, acc, _ = _call(base, "POST", "/v1/extract", json.dumps(
        {"video_paths": ["/v.mp4"], "timeout_s": 0.6}).encode())
    assert st == 202
    term = serve.wait_response(str(tmp_path / "spool"), acc["id"],
                               timeout_s=30)
    assert term["status"] == "deadline_exceeded"
    assert term["expired_at"] in ("queued", "spooled")
    st, polled, _ = _call(base, "GET", f"/v1/requests/{acc['id']}")
    assert st == 200 and polled["status"] == "deadline_exceeded"
    assert not list((tmp_path / "spool" / "requests").glob("*.json"))
    g.stop()
    ok, violations, notes = audit_run(str(tmp_path), expect_complete=True)
    assert ok, "\n".join(violations)
    # the port's audit: the same verdict, violations and notes
    from video_features_tpu_torch.audit import audit_run as taudit_run
    assert taudit_run(str(tmp_path), expect_complete=True) == (
        ok, violations, notes)
    events = [json.loads(ln)["event"]
              for ln in Path(g.journal_path).read_text().splitlines()]
    assert "accepted" in events and "expired" in events


def test_stop_flushes_queued_requests_into_spool(tmp_path):
    g = gateway.GatewayServer({"spool_dir": str(tmp_path / "spool"),
                               "gateway_spool_bound": 1,
                               "gateway_poll_interval_s": 30,
                               "metrics_interval_s": 30})
    rids = [g.admit(g.tenants[None], ["/v.mp4"], None)[1]["id"]
            for _ in range(3)]
    g.start()
    g.stop()
    spooled = {p.stem for p
               in (tmp_path / "spool" / "requests").glob("*.json")}
    assert spooled == set(rids)
    hb = json.loads(next((tmp_path / "spool").glob(
        "_heartbeat_gw-*.json")).read_text())
    assert hb["final"] and hb["gateway"]["state"] == "exited"
    events = [json.loads(ln)["event"]
              for ln in Path(g.journal_path).read_text().splitlines()]
    assert events.count("submitted") == 3 and events[-1] == "drain"
    # a port server's readiness probe ignores the gateway's heartbeat
    assert serve.server_state(str(tmp_path / "spool")) == \
        {"state": "absent"}


# -- the injection sites ---------------------------------------------------------

def test_parse_plan_gateway_sites():
    p = inject.parse_plan(
        "seed=3;gateway.read=torn@n1;gateway.spool_submit=drop@n2;"
        "spool.respond=drop@every2")
    assert set(p.rules) == {"gateway.read", "gateway.spool_submit",
                            "spool.respond"}
    inject.parse_plan("gateway.read=stall@n1")
    inject.parse_plan("gateway.spool_submit=enospc@n1")
    for spec in ("gateway.read=drop@n1", "spool.respond=torn@n1"):
        with pytest.raises(ValueError, match="only applies"):
            inject.parse_plan(spec)


def test_gateway_read_torn_is_a_400_and_stall_still_stores(gw):
    g, base = gw
    inject.arm_for_run("seed=1;gateway.read=torn@n1")
    try:
        st, err, _ = _call(base, "POST", "/v1/upload?name=a.mp4",
                           b"0123456789" * 10, key="alpha-k")
    finally:
        inject.disarm()
    assert st == 400 and "torn body" in err["error"]
    assert not list(Path(g.inbox_dir).iterdir())
    inject.arm_for_run("seed=1;gateway.read=stall@n1")
    try:
        st, up, _ = _call(base, "POST", "/v1/upload?name=a.mp4",
                          b"0123456789" * 10, key="alpha-k")
    finally:
        inject.disarm()
    assert st == 201 and Path(up["path"]).exists()


def test_gateway_spool_submit_drop_resolves_as_lost(tmp_path):
    """A submit lost after the gateway believed it landed: no server ever
    sees the request, and past ``deadline + grace`` the gateway writes the
    terminal ``expired`` record itself (``expired_at: lost``)."""
    inject.arm_for_run("seed=1;gateway.spool_submit=drop@n1")
    try:
        g = gateway.GatewayServer({"spool_dir": str(tmp_path / "spool"),
                                   "gateway_poll_interval_s": 0.05,
                                   "gateway_expire_grace_s": 0.3,
                                   "metrics_interval_s": 1}).start()
        code, body, _ = g.admit(g.tenants[None], ["/v.mp4"], 0.4)
        assert code == 202
        term = serve.wait_response(str(tmp_path / "spool"), body["id"],
                                   timeout_s=30)
        g.stop()
    finally:
        inject.disarm()
    assert term["status"] == "deadline_exceeded"
    assert term["expired_at"] in ("lost", "spooled")
    assert not list((tmp_path / "spool" / "requests").glob("*.json"))
