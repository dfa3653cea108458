"""The port's work-stealing fleet queue (``parallel/queue.py``) and the CLI's
``fleet=queue`` path against the JAX package.

- The cases of the JAX ``tests/test_fleet.py`` on the port's ``WorkQueue``
  (claim atomicity, lease expiry and stealing, heartbeat-driven reclaim,
  quarantine after ``max_reclaims``, first-writer-wins completion, the
  staging sweep, drain, the heartbeat section and the canary gate with its
  digest and timing bands), each with an injected clock and no sleeps
  (drain on a real clock with millisecond polls);
- the ``queue.claim`` and ``queue.steal_staging`` sites as the JAX
  ``tests/test_inject.py`` fires them;
- a JAX ``WorkQueue`` and a port ``WorkQueue`` drain one ``_queue`` root
  concurrently: each item is done exactly once;
- the port's canary bands are the scripts' (``scripts/compare_runs.py``,
  ``scripts/bench_history.py``) on the same inputs;
- the CLI (resnet18 on the CPU): two ``fleet=queue`` runs over one root do
  each video once, bit-equal to a static run, with the ``fleet`` heartbeat
  section; a third host joins with ``fleet_canary=true`` and passes; the
  JAX ``audit.audit_run`` finds no violation in the queue tree, and the
  port's ``audit_run`` agrees word for word; the JAX CLI drains its own
  queue to the same features within the value tier; the CLI hands
  ``gc_staging_retention_s`` to the queue as the JAX CLI does.
"""
import contextlib
import importlib.util
import io
import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu_torch.parallel import queue as fq
from video_features_tpu_torch.telemetry.heartbeat import heartbeat_filename
from video_features_tpu_torch.telemetry.jsonl import (append_jsonl,
                                                      write_json_atomic)
from video_features_tpu_torch.utils import inject

REPO = Path(__file__).resolve().parents[1]


class Clock:
    """Injectable time source: tests advance leases, never sleep."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _hb(root, host, *, now, age_s=0.0, interval_s=1.0, final=False):
    write_json_atomic(
        os.path.join(str(root), heartbeat_filename(host)),
        {"host_id": host, "time": now - age_s, "interval_s": interval_s,
         "final": final})


def _wq(root, host, clk, mod=fq, **kw):
    kw.setdefault("lease_s", 5.0)
    return mod.WorkQueue(str(root), host_id=host, run_id=f"run-{host}",
                         clock=clk, **kw)


def test_seed_idempotent_and_concurrent(tmp_path):
    clk = Clock()
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    videos = [f"/data/v{i:02d}.mp4" for i in range(10)]
    assert a.seed(videos) == 10
    assert b.seed(videos) == 0
    assert a.counts() == {"pending": 10, "claimed": 0, "done": 0,
                          "quarantined": 0}


def test_item_ids_and_layout_are_jax(tmp_path):
    """The item id and the directory layout are the JAX package's, so
    hosts of either package share one queue."""
    from video_features_tpu.parallel import queue as jq
    for video in ("/data/v 1.mp4", "a/b/c.avi", "x"):
        assert fq.item_id(video) == jq.item_id(video)
    _wq(tmp_path, "A", Clock())
    assert sorted(os.listdir(tmp_path / "_queue")) == sorted(
        [".staging", "claimed", "done", "pending", "quarantined"])
    assert (fq.ITEM_SCHEMA, fq.DONE_SCHEMA, fq.QUEUE_DIRNAME) == \
        (jq.ITEM_SCHEMA, jq.DONE_SCHEMA, jq.QUEUE_DIRNAME)


def test_claim_atomicity_concurrent_claimants(tmp_path):
    """4 hosts x 2 threads claim from one queue: no item twice, none
    lost."""
    clk = Clock()
    videos = [f"/data/v{i:03d}.mp4" for i in range(40)]
    hosts = [_wq(tmp_path, f"h{i}", clk) for i in range(4)]
    hosts[0].seed(videos)
    claimed, lock = [], threading.Lock()

    def worker(q):
        while True:
            rec = q.claim_next()
            if rec is None:
                return
            with lock:
                claimed.append(rec["video"])

    threads = [threading.Thread(target=worker, args=(q,))
               for q in hosts for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(claimed) == sorted(videos)
    c = hosts[0].counts()
    assert c["pending"] == 0 and c["claimed"] == len(videos)
    assert sum(q._tallies["claimed"] for q in hosts) == len(videos)


def test_lease_expiry_is_stolen_and_tallied(tmp_path):
    clk = Clock()
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    _hb(tmp_path, "A", now=clk.t, interval_s=60.0)
    a.seed(["/data/slow.mp4"])
    rec = a.claim_next()
    assert rec["deadline"] == pytest.approx(clk.t + 5.0)
    assert b.reclaim_expired() == 0
    clk.t += 6.0
    assert b.reclaim_expired() == 1
    stolen = b.claim_next()
    assert stolen["video"] == "/data/slow.mp4"
    assert stolen["reclaims"] == 1 and stolen["last_owner"] == "A"
    assert b._tallies["stolen"] == 1 and b._tallies["reclaimed"] == 1


def test_live_renewal_prevents_stealing(tmp_path):
    clk = Clock()
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    _hb(tmp_path, "A", now=clk.t)
    a.seed(["/data/v.mp4"])
    a.claim_next()
    for _ in range(4):
        clk.t += 3.0
        _hb(tmp_path, "A", now=clk.t)
        a.renew_leases()
        assert b.reclaim_expired() == 0
    assert a.counts()["claimed"] == 1


def test_stale_heartbeat_releases_unexpired_lease(tmp_path):
    clk = Clock()
    a = _wq(tmp_path, "A", clk, lease_s=10_000.0)
    b = _wq(tmp_path, "B", clk, lease_s=10_000.0)
    a.seed(["/data/v.mp4"])
    a.claim_next()
    _hb(tmp_path, "A", now=clk.t, interval_s=1.0)
    assert b.reclaim_expired() == 0
    clk.t += 10.0  # past STALL_INTERVALS heartbeats, lease not expired
    assert b.reclaim_expired() == 1
    assert b.claim_next()["last_owner"] == "A"


def test_final_heartbeat_releases_claims(tmp_path):
    clk = Clock()
    a = _wq(tmp_path, "A", clk, lease_s=10_000.0)
    b = _wq(tmp_path, "B", clk, lease_s=10_000.0)
    a.seed(["/data/v.mp4"])
    a.claim_next()
    _hb(tmp_path, "A", now=clk.t, final=True)
    assert b.reclaim_expired() == 1


def test_quarantine_after_max_reclaims(tmp_path):
    """Reclaimed past ``max_reclaims``: quarantined, and a POISON record
    in the port's failure journal."""
    from video_features_tpu_torch.utils.faults import FailureJournal
    clk = Clock()
    journal = FailureJournal(str(tmp_path / "j"))
    a = _wq(tmp_path, "A", clk, max_reclaims=2, journal=journal)
    b = _wq(tmp_path, "B", clk, max_reclaims=2, journal=journal)
    a.seed(["/data/poison.mp4"])
    for stealer, victim in ((b, a), (a, b), (b, a)):
        victim.claim_next()
        clk.t += 6.0
        stealer.reclaim_expired()
    assert a.counts() == {"pending": 0, "claimed": 0, "done": 0,
                          "quarantined": 1}
    qdir = tmp_path / "_queue" / "quarantined"
    q = json.loads((qdir / os.listdir(qdir)[0]).read_text())
    assert q["reclaims"] == 3
    recs = [json.loads(line) for line in
            open(journal.path) if line.strip()]
    assert [(r["video"], r["category"]) for r in recs] == [
        ("/data/poison.mp4", "POISON")]
    assert "fleet_max_reclaims" in recs[0]["error"]


def test_complete_first_writer_wins(tmp_path):
    clk = Clock()
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    a.seed(["/data/v.mp4"])
    rec_a = a.claim_next()
    clk.t += 6.0
    b.reclaim_expired()
    rec_b = b.claim_next()
    assert b.complete(rec_b, "done") is True
    assert a.complete(rec_a, "done") is False
    done = list((tmp_path / "_queue" / "done").glob("*.json"))
    assert len(done) == 1
    assert json.loads(done[0].read_text())["by"] == "B"
    assert a._tallies["lease_lost"] == 1 and b._tallies["done"] == 1
    assert a.all_done() and b.all_done()


def test_done_item_never_reclaimed_or_reseeded(tmp_path):
    clk = Clock()
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    a.seed(["/data/v.mp4"])
    a.complete(a.claim_next(), "done")
    assert b.seed(["/data/v.mp4"]) == 0
    iid = fq.item_id("/data/v.mp4")
    (tmp_path / "_queue" / "pending" / f"{iid}.json").write_text(
        json.dumps({"schema": fq.ITEM_SCHEMA, "id": iid,
                    "video": "/data/v.mp4", "reclaims": 0}))
    assert b.claim_next() is None
    assert b._tallies["duplicate_discarded"] == 1
    assert b.all_done()


def test_release_returns_item_unbumped(tmp_path):
    clk = Clock()
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    a.seed(["/data/v.mp4"])
    a.release(a.claim_next())
    assert a.counts()["pending"] == 1
    again = b.claim_next()
    assert again["reclaims"] == 0 and b._tallies["stolen"] == 0


def test_staging_orphan_recovered(tmp_path):
    clk = Clock()
    a = _wq(tmp_path, "A", clk, lease_s=5.0)
    staging = tmp_path / "_queue" / ".staging" / "dead.it-1234.json"
    staging.write_text(json.dumps(
        {"schema": fq.ITEM_SCHEMA, "id": "it-1234",
         "video": "/data/v.mp4", "reclaims": 1}))
    os.utime(staging, (clk.t - 30.0, clk.t - 30.0))
    assert a.reclaim_expired() == 1
    rec = a.claim_next()
    assert rec["id"] == "it-1234" and rec["reclaims"] == 1


def test_staging_retention_replaces_lease_heuristic(tmp_path):
    clk = Clock()
    a = _wq(tmp_path, "A", clk, lease_s=5.0, staging_retention_s=100.0)
    staging = tmp_path / "_queue" / ".staging" / "dead.it-7.json"
    staging.write_text(json.dumps(
        {"schema": fq.ITEM_SCHEMA, "id": "it-7",
         "video": "/data/v.mp4", "reclaims": 0}))
    os.utime(staging, (clk.t - 30.0, clk.t - 30.0))
    assert a.reclaim_expired() == 0
    clk.t += 80.0
    assert a.reclaim_expired() == 1
    assert a.claim_next()["id"] == "it-7"
    with pytest.raises(ValueError):
        _wq(tmp_path, "B", clk, staging_retention_s=0.0)


def _drain_threads(hosts, run_fn):
    threads = [threading.Thread(
        target=lambda h=h: h.drain(run_fn, workers=2, poll_s=0.02))
        for h in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_drain_exactly_once_across_hosts(tmp_path):
    videos = [f"/data/v{i:02d}.mp4" for i in range(12)]
    hosts = [fq.WorkQueue(str(tmp_path), host_id=f"h{i}", lease_s=60.0)
             for i in range(3)]
    for i in range(3):
        _hb(tmp_path, f"h{i}", now=time.time())
    for h in hosts:
        h.seed(videos)
    ran, lock = [], threading.Lock()

    def run_fn(video):
        with lock:
            ran.append(video)
        return "done"

    _drain_threads(hosts, run_fn)
    assert sorted(ran) == sorted(videos)
    assert len(list((tmp_path / "_queue" / "done").glob("*.json"))) == \
        len(videos)
    sections = [h.heartbeat_section() for h in hosts]
    assert sum(s["claimed"] for s in sections) == len(videos)
    assert all(s["mode"] == "queue" for s in sections)


def test_jax_and_port_hosts_drain_one_queue_exactly_once(tmp_path):
    """Two JAX hosts and two port hosts seed and drain one ``_queue``
    root at once: every item runs exactly once, and the done markers name
    hosts of both packages."""
    from video_features_tpu.parallel import queue as jq
    videos = [f"/data/v{i:02d}.mp4" for i in range(24)]
    hosts = ([jq.WorkQueue(str(tmp_path), host_id=f"jax{i}", lease_s=60.0)
              for i in range(2)]
             + [fq.WorkQueue(str(tmp_path), host_id=f"port{i}",
                             lease_s=60.0) for i in range(2)])
    for h in hosts:
        _hb(tmp_path, h.host_id, now=time.time())
        h.seed(videos)
    ran, lock = [], threading.Lock()
    started = {"jax": threading.Event(), "port": threading.Event()}

    def run_fn_of(pkg, other):
        def run_fn(video):
            with lock:
                ran.append(video)
            started[pkg].set()
            # each package's first items wait (bounded) for the other's,
            # so both packages' hosts take part however the threads start
            started[other].wait(timeout=30)
            return "done"
        return run_fn

    threads = [threading.Thread(target=lambda h=h: h.drain(
        run_fn_of(*(("jax", "port") if h.host_id.startswith("jax")
                    else ("port", "jax"))), workers=2, poll_s=0.02))
        for h in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(ran) == sorted(videos)
    done = [json.loads(p.read_text())
            for p in (tmp_path / "_queue" / "done").glob("*.json")]
    assert sorted(d["video"] for d in done) == sorted(videos)
    by = {d["by"][:3] for d in done}
    assert by == {"jax", "por"}, by
    assert jq.WorkQueue(str(tmp_path), host_id="jx").counts() == \
        fq.WorkQueue(str(tmp_path), host_id="pt").counts()


def test_heartbeat_section_renews_leases(tmp_path):
    clk = Clock()
    a = _wq(tmp_path, "A", clk)
    a.seed(["/data/v.mp4"])
    rec = a.claim_next()
    first = rec["deadline"]
    clk.t += 3.0
    section = a.heartbeat_section()
    assert section["active_claims"] == 1
    assert section["oldest_active_claim_age_s"] == pytest.approx(3.0)
    stamped = json.loads(Path(a._claim_path(rec["id"])).read_text())
    assert stamped["deadline"] == pytest.approx(first + 3.0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_renewal_racing_a_completion_leaves_no_orphan_claim(
        tmp_path, monkeypatch, package):
    """The heartbeat thread's renewal checks a claim, then rewrites it; a
    completion that unlinks the claim in between must not be undone. The
    renewal's write here first lets the completion run on another thread
    (up to 1 s). In JAX's ``WorkQueue`` the completion finishes inside the
    window and the write brings the claim back: an orphan in A's own claim
    directory that A never renews and never reclaims, so the queue is not
    drained and host B, with A's heartbeat fresh, waits out the lease
    before it may requeue it (a fault that could explain the fleet
    queue's 75 s two-worker run on the card; that it did is not shown).
    The port's renewal holds the lock that the completion takes,
    so the completion waits for the write and then removes the claim."""
    from video_features_tpu.parallel import queue as jq
    mod = fq if package == "port" else jq
    clk = Clock()
    a = _wq(tmp_path, "A", clk, mod=mod)
    b = _wq(tmp_path, "B", clk, mod=mod)
    a.seed(["/data/v.mp4"])
    rec = a.claim_next()
    claim = a._claim_path(rec["id"])
    write = mod.write_json_atomic
    done = threading.Event()
    raced = []

    def racing_write(path, obj, *args, **kw):
        if path == claim and not raced:
            th = threading.Thread(
                target=lambda: (a.complete(rec, "done"), done.set()))
            th.start()
            raced.append(th)
            th.join(timeout=1.0)
        return write(path, obj, *args, **kw)

    monkeypatch.setattr(mod, "write_json_atomic", racing_write)
    clk.t += 1.0
    a.renew_leases()
    raced[0].join(timeout=10.0)
    assert done.is_set() and not raced[0].is_alive()
    _hb(tmp_path, "A", now=clk.t)
    assert b.reclaim_expired() == 0
    orphaned = package == "jax"
    assert os.path.exists(claim) is orphaned
    assert a.counts()["claimed"] == int(orphaned)
    assert a.all_done() is not orphaned and b.all_done() is not orphaned
    if orphaned:  # B may requeue it only once the lease has run out
        clk.t += a.lease_s + 1.0
        assert b.reclaim_expired() == 1 and b.claim_next() is None
        assert b.all_done()


def test_heartbeat_section_keys_are_jax(tmp_path):
    from video_features_tpu.parallel import queue as jq
    clk = Clock()
    port = _wq(tmp_path / "p", "A", clk).heartbeat_section()
    jax = _wq(tmp_path / "j", "A", clk, mod=jq).heartbeat_section()
    assert port == jax


def test_canary_founding_member_passes(tmp_path):
    a = _wq(tmp_path, "A", Clock())
    ok, lines = a.canary_gate(lambda v, d: ("done", 0.1))
    assert ok and "founding member" in lines[0]
    assert a.heartbeat_section()["canary"] == "founding"


def test_report_renders_the_fleet_line_and_straggler(tmp_path):
    from video_features_tpu_torch.telemetry import report
    now = time.time()
    fleet_a = {"mode": "queue", "active_claims": 1, "claimed": 5,
               "done": 4, "stolen": 1, "reclaimed": 1, "requeued": 1,
               "oldest_active_claim_age_s": 42.0,
               "queue": {"pending": 0, "claimed": 1, "done": 10},
               "canary": "off"}
    fleet_b = dict(fleet_a, active_claims=0, claimed=6, done=6, stolen=0,
                   oldest_active_claim_age_s=0.0)
    for host, fl in (("hostA", fleet_a), ("hostB", fleet_b)):
        write_json_atomic(
            tmp_path / f"_heartbeat_{host}.json",
            {"host_id": host, "time": now, "interval_s": 30.0,
             "final": False, "videos_done": fl["done"], "fleet": fl})
    paths = [str(p) for p in tmp_path.glob("_heartbeat_*.json")]
    out = "\n".join(report.render_heartbeats(paths, now))
    assert "fleet: claimed=5 done=4 stolen=1" in out
    a_line = next(ln for ln in out.splitlines() if "claimed=5" in ln)
    b_line = next(ln for ln in out.splitlines() if "claimed=6" in ln)
    assert "STRAGGLER" in a_line and "STRAGGLER" not in b_line


def _health_rec(video, *, mean=0.5, sig="sigA"):
    return {"schema": "vft.feature_health/1", "video": str(video),
            "feature_type": "resnet", "key": "resnet",
            "shape": [4, 512], "dtype": "float32", "elems": 2048,
            "nan": 0, "inf": 0, "min": 0.0, "max": 1.0, "mean": mean,
            "std": 0.1, "l2": 10.0, "sig": sig, "time": 1.0}


def _done_fleet(tmp_path, clk, n=2, elapsed_s=2.0):
    a = _wq(tmp_path, "A", clk)
    vids = []
    for i in range(n):
        v = tmp_path / f"v{i}.mp4"
        v.write_bytes(b"x")
        vids.append(str(v))
    a.seed(vids)
    for _ in range(n):
        a.complete(a.claim_next(), "done", elapsed_s=elapsed_s)
    for v in vids:
        append_jsonl(tmp_path / "_health.jsonl", _health_rec(v))
    return vids


def _extract(mean=0.5, sig="sigA", elapsed=1.5):
    def fn(video, out_dir):
        append_jsonl(Path(out_dir) / "_health.jsonl",
                     _health_rec(video, mean=mean, sig=sig))
        return "done", elapsed
    return fn


def test_canary_gate_digest_and_timing_bands(tmp_path):
    clk = Clock()
    _done_fleet(tmp_path, clk)
    ok, lines = _wq(tmp_path, "B", clk).canary_gate(_extract())
    assert ok, lines
    assert any("PASS" in ln for ln in lines)
    ok, lines = _wq(tmp_path, "C", clk).canary_gate(
        _extract(mean=0.9, sig="sigZ"))
    assert not ok and any("DIGEST DRIFT" in ln for ln in lines), lines
    ok, lines = _wq(tmp_path, "D", clk).canary_gate(_extract(elapsed=30.0))
    assert not ok
    assert any("timing band" in ln and "FAIL" in ln for ln in lines), lines
    verdicts = [json.loads(p.read_text()) for p in
                (tmp_path / "_queue" / "canary").glob("*.json")]
    assert sorted(v["ok"] for v in verdicts) == [False, False, True]


@pytest.mark.parametrize("case", ["pass", "drift", "slow"])
def test_canary_verdict_lines_equal_jax(tmp_path, case):
    """A JAX joiner and a port joiner gated on the same done work with
    the same re-extraction give the same verdict and lines (the JAX gate
    loads the scripts, the port its own copies of their bands)."""
    from video_features_tpu.parallel import queue as jq
    clk = Clock()
    _done_fleet(tmp_path, clk)
    fn = {"pass": _extract(), "drift": _extract(mean=0.9, sig="sigZ"),
          "slow": _extract(elapsed=30.0)}[case]
    got = {}
    for name, mod in (("port", fq), ("jax", jq)):
        ok, lines = _wq(tmp_path, f"B{name}", clk, mod=mod).canary_gate(fn)
        got[name] = (ok, [ln.replace(f"B{name}", "B") for ln in lines
                          if "_canary_history" not in ln])
    assert got["port"] == got["jax"]
    assert got["port"][0] == (case == "pass")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_t_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_band_copies_equal_the_scripts(tmp_path):
    """``load_health``/``compare_digests`` and ``check_regressions`` give
    what ``scripts/compare_runs.py`` and ``scripts/bench_history.py``
    give on the same files."""
    cr, bh = _load_script("compare_runs"), _load_script("bench_history")
    for root, means in (("a", (0.5, 0.2)), ("b", (0.505, 0.9))):
        for i, mean in enumerate(means):
            append_jsonl(tmp_path / root / "_health.jsonl",
                         _health_rec(f"/x/v{i}.mp4", mean=mean,
                                     sig=f"s{root}{i}"))
    da, db = fq.load_health(tmp_path / "a"), fq.load_health(tmp_path / "b")
    assert da == cr.load_health(tmp_path / "a")
    for atol, rtol in ((1e-2, 0.02), (1e-3, 0.0)):
        assert fq.compare_digests(da, db, atol, rtol) == \
            cr.compare_digests(da, db, atol, rtol)
    hist = tmp_path / "h.jsonl"
    for rnd, val in ((1, 2.0), (2, 3.0)):
        append_jsonl(hist, {"schema": bh.SCHEMA_VERSION, "round": rnd,
                            "source": "s", "recorded_time": 1.0,
                            "headline": {"metric": "x seconds per video",
                                         "value": val,
                                         "unit": "seconds per video"},
                            "metrics": []})
    for band in (0.25, 1.0):
        assert fq.check_regressions(str(hist), band) == \
            bh.check_regressions(str(hist), band)


def test_canary_warm_tightens_timing_band_and_heartbeat(tmp_path):
    clk = Clock()
    _done_fleet(tmp_path, clk, n=1)

    def extract(video, out_dir):
        append_jsonl(Path(out_dir) / "_health.jsonl", _health_rec(video))
        return "done", 3.0  # 1.5x the fleet median

    cold = _wq(tmp_path, "B", clk)
    ok, lines = cold.canary_gate(extract)
    assert ok, lines
    sect = cold.heartbeat_section()
    assert sect["canary_warm"] is False and sect["idle_wait_s_total"] == 0.0
    warm = _wq(tmp_path, "C", clk)
    warm.canary_warm = True
    ok, lines = warm.canary_gate(extract)
    assert not ok
    assert any("compile cache warm" in ln and "tightened" in ln
               for ln in lines), lines
    assert warm.heartbeat_section()["canary_warm"] is True
    verdict = json.loads(
        (tmp_path / "_queue" / "canary" / "C.json").read_text())
    assert verdict["canary_warm"] is True and verdict["ok"] is False


def test_drain_accumulates_idle_wait(tmp_path):
    clk = Clock()
    _hb(tmp_path, "A", now=clk.t)
    _hb(tmp_path, "B", now=clk.t)
    a, b = _wq(tmp_path, "A", clk), _wq(tmp_path, "B", clk)
    a.seed(["only.mp4"])
    rec = a.claim_next()

    def finish():
        time.sleep(0.12)
        a.complete(rec, "done")
    t = threading.Thread(target=finish)
    t.start()
    b.drain(lambda v: "done", workers=1, stop=threading.Event(),
            poll_s=0.02)
    t.join(timeout=30)
    assert b.heartbeat_section()["idle_wait_s_total"] > 0.0


# -- the injection sites (the JAX tests/test_inject.py cases) ---------------

@pytest.fixture
def armed():
    yield inject.arm_for_run
    inject.disarm()


def test_queue_claim_skew_makes_lease_immediately_stealable(tmp_path,
                                                            armed):
    now = [1000.0]
    qa = _wq(tmp_path, "hostA", lambda: now[0], lease_s=10.0)
    qb = _wq(tmp_path, "hostB", lambda: now[0], lease_s=10.0)
    qa.seed(["v0.mp4"])
    _hb(tmp_path, "hostA", now=now[0])
    _hb(tmp_path, "hostB", now=now[0])
    armed("seed=1;queue.claim=skew@n1")
    rec = qa.claim_next()
    assert float(rec["deadline"]) < now[0]
    inject.disarm()
    assert qb.reclaim_expired() == 1
    stolen = qb.claim_next()
    assert stolen["reclaims"] == 1 and stolen["last_owner"] == "hostA"


def test_queue_claim_eio_is_a_lost_race(tmp_path, armed):
    qa = _wq(tmp_path, "hostA", Clock())
    qa.seed(["v0.mp4", "v1.mp4"])
    plan = armed("seed=1;queue.claim=eio@n1")
    rec = qa.claim_next()
    assert rec["video"] == "v1.mp4"  # the first claim failed like a race
    assert qa.counts()["pending"] == 1
    assert "queue.claim" in plan.summary()


def test_queue_steal_staging_drop_recovered_by_sweep(tmp_path, armed):
    now = [1000.0]
    qa = _wq(tmp_path, "hostA", lambda: now[0], lease_s=10.0)
    qb = _wq(tmp_path, "hostB", lambda: now[0], lease_s=10.0)
    qa.seed(["v0.mp4"])
    _hb(tmp_path, "hostB", now=now[0])
    assert qa.claim_next() is not None
    now[0] += 100.0
    armed("seed=1;queue.steal_staging=drop@n1")
    assert qb.reclaim_expired() == 0
    inject.disarm()
    staging = list(Path(qb.root, ".staging").glob("*.json"))
    assert len(staging) == 1
    os.utime(staging[0], (now[0] - 100.0, now[0] - 100.0))
    assert qb.reclaim_expired() == 1
    assert qb.claim_next()["video"] == "v0.mp4"


# -- the CLI's fleet=queue path -----------------------------------------------

def _cli(argv):
    from video_features_tpu_torch.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _argv(tmp_path, vids, out="out", **over):
    cfg = dict(feature_type="resnet", model_name="resnet18", device="cpu",
               allow_random_weights="false", on_extraction="save_numpy",
               extraction_total=3, batch_size=8, telemetry="true",
               health="true", metrics_interval_s=0.3, fleet="queue",
               fleet_lease_s=10, output_path=str(tmp_path / out),
               tmp_path=str(tmp_path / "tmp"),
               video_paths="[" + ",".join(vids) + "]")
    cfg.update(over)
    return [f"{k}={v}" for k, v in cfg.items()]


@pytest.fixture(scope="module")
def fleet_tree(tmp_path_factory, sample_video):
    """Two ``fleet=queue`` CLI hosts over three copies of the sample, a
    static single-host run of the same, then a third host joining the
    drained queue with ``fleet_canary=true``."""
    import torch

    from video_features_tpu_torch.models.resnet import ResNet
    from video_features_tpu_torch.weights.bridge import seeded_init_
    tmp = tmp_path_factory.mktemp("fleet_cli")
    ckpt = tmp / "resnet18.pt"
    torch.save(seeded_init_(ResNet("resnet18"), 3).state_dict(), ckpt)
    vids = []
    for i in range(3):
        vids.append(str(tmp / f"v_fleet_{i}.mp4"))
        shutil.copy(sample_video, vids[-1])
    # the hosts take turns on this thread (the queue's concurrency is the
    # unit tests' and the chip_smoke fleet phase's, which runs two worker
    # processes at once): the canary's timing band then compares runs made
    # under one thread's conditions
    outs = [_cli(_argv(tmp, vids, weights_path=ckpt)) for _ in range(2)]
    static = _cli(_argv(tmp, vids, out="static", fleet="static",
                        weights_path=ckpt))
    canary = _cli(_argv(tmp, vids, fleet_canary="true", weights_path=ckpt))
    return dict(tmp=tmp, vids=vids, outs=outs, ckpt=ckpt,
                static=static, canary=canary,
                root=tmp / "out" / "resnet" / "resnet18")


def test_cli_fleet_hosts_do_each_video_once_bit_equal_to_static(
        fleet_tree):
    assert "3 extracted" in fleet_tree["outs"][0]
    assert "0 extracted" in fleet_tree["outs"][1]  # nothing left to claim
    root = fleet_tree["root"]
    done = [json.loads(p.read_text())
            for p in (root / "_queue" / "done").glob("*.json")]
    assert sorted(d["video"] for d in done) == sorted(fleet_tree["vids"])
    assert {d["status"] for d in done} == {"done"}
    assert not list((root / "_queue" / "quarantined").glob("*.json"))
    static = fleet_tree["tmp"] / "static" / "resnet" / "resnet18"
    names = sorted(p.name for p in static.glob("*.npy"))
    assert len(names) == 9
    for name in names:
        assert (root / name).read_bytes() == (static / name).read_bytes()
    beats = [json.loads(p.read_text())
             for p in root.glob("_heartbeat_*.json")]
    fleets = [b["fleet"] for b in beats]
    assert len(fleets) == 3 and all(f["mode"] == "queue" for f in fleets)
    assert sum(f["done"] for f in fleets) == 3
    assert all(b["final"] for b in beats)


def test_cli_canary_join_passes_end_to_end(fleet_tree):
    out = fleet_tree["canary"]
    assert "fleet canary" in out and "0 extracted" in out
    qdir = fleet_tree["root"] / "_queue"
    verdicts = [json.loads(p.read_text())
                for p in (qdir / "canary").glob("*.json")]
    assert len(verdicts) == 1 and verdicts[0]["ok"] is True, verdicts
    assert len(verdicts[0]["videos"]) == 2
    assert any("digest(s) compared" in ln and "PASS" in ln
               for ln in verdicts[0]["lines"])


def test_jax_audit_finds_no_violation_in_the_queue_tree(fleet_tree):
    """And the port's audit gives the same verdict, violations and notes."""
    from video_features_tpu import audit
    from video_features_tpu_torch import audit as taudit
    ok, violations, notes = audit.audit_run(str(fleet_tree["root"]),
                                            expect_complete=True)
    assert ok, violations
    assert taudit.audit_run(str(fleet_tree["root"]),
                            expect_complete=True) == (ok, violations, notes)


def test_fleet_report_reads_the_queue_tree(fleet_tree):
    from video_features_tpu_torch import fleet_report
    agg = fleet_report.aggregate(str(fleet_tree["root"]))
    queue = agg.get("queue") or {}
    assert queue.get("done") == 3 and not queue.get("pending"), queue
    # every worker's heartbeat is read (the hosts share one _run.json, so
    # only the last to exit matches its run id)
    assert len(agg["hosts"]) == 3


def test_fleet_queue_features_match_jax_value_tier(fleet_tree, tmp_path):
    """The JAX CLI drains its own queue over one of the videos on the same
    checkpoint: the same done set, and the port's queue-drained features
    within the value tier (atol 1e-2) of JAX's."""
    from video_features_tpu.cli import main as jmain
    vids = fleet_tree["vids"][:1]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        jmain(_argv(tmp_path, vids, out="jax",
                    weights_path=fleet_tree["ckpt"]))
    jroot = tmp_path / "jax" / "resnet" / "resnet18"
    jdone = sorted(json.loads(p.read_text())["video"]
                   for p in (jroot / "_queue" / "done").glob("*.json"))
    assert jdone == vids
    stem = Path(vids[0]).stem
    for key in ("resnet", "fps", "timestamps_ms"):
        port = np.load(fleet_tree["root"] / f"{stem}_{key}.npy")
        jax = np.load(jroot / f"{stem}_{key}.npy")
        np.testing.assert_allclose(port, jax, atol=1e-2, rtol=0, err_msg=key)


def test_cli_passes_gc_staging_retention_to_the_queue(tmp_path, monkeypatch):
    """``fleet=queue`` with ``gc_staging_retention_s=30``: the port's CLI
    builds its ``WorkQueue`` with ``staging_retention_s`` 30.0, as the JAX
    CLI does (both runs with a stand-in extractor and a drain that claims
    nothing), and a ``.staging/`` orphan 31 s old goes back to pending on
    the next recovery sweep (the lease heuristic alone waits 4 leases of
    the test's 10 s)."""
    import video_features_tpu.cli as jcli
    from video_features_tpu.parallel import queue as jq
    from video_features_tpu_torch import cli as tcli

    built = {}

    class Stub:
        video_decode = "inline"

        def __init__(self, args):
            pass

    def recording(mod, name):
        class Recording(mod.WorkQueue):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built[name] = self

            def drain(self, *a, **kw):
                return None
        return Recording

    monkeypatch.setattr(tcli, "get_extractor_cls", lambda ft: Stub)
    monkeypatch.setattr(fq, "WorkQueue", recording(fq, "port"))
    monkeypatch.setattr(jcli, "get_extractor_cls", lambda ft: Stub)
    monkeypatch.setattr(jq, "WorkQueue", recording(jq, "jax"))
    video = str(REPO / "tests" / "assets" / "v_synth_sample.mp4")
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        argv = _argv(tmp_path, [video], out=name,
                     gc_staging_retention_s=30, health="false")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            main(argv)
    assert built["port"].staging_retention_s == 30.0 == \
        built["jax"].staging_retention_s
    wq = built["port"]
    now = time.time()
    staging = Path(wq.root) / ".staging" / "dead.it-31.json"
    staging.write_text(json.dumps(
        {"schema": fq.ITEM_SCHEMA, "id": "it-31", "video": "/data/v.mp4",
         "reclaims": 0}))
    os.utime(staging, (now - 31.0, now - 31.0))
    assert wq.reclaim_expired() == 1
    assert (Path(wq.root) / "pending" / "it-31.json").exists()
