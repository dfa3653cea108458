"""The seeded chaos matrix on the port (JAX ``tests/test_chaos.py``).

- ``CHAOS_PLANS``: every seed runs the port's CLI over the JAX test's
  configuration (``resnet,clip`` with resnet18 over one shared decode,
  ``extraction_total=4``, ``batch_size=8``, two copies of the sample,
  ``fleet=queue telemetry=true health=true cache=true``) with a
  deterministic fault plan (``utils/inject.py``). Every fault is
  survivable, so the port's audit passes ``--expect-complete`` and the
  ``.npy`` bytes equal the port's clean run's (no fleet, no fault); the
  port's ``compare`` gives ``PASS`` against a clean run with the same
  keys. Seeds 0 and 1 run in tier 1 and seeds 2-7 are marked ``slow``, as
  JAX marks them.
- ``GATEWAY_CHAOS_PLANS`` 30 and 31: the three ingress sites
  (``gateway.read``, ``gateway.spool_submit``, ``spool.respond``) against
  the port's in-process ``GatewayServer`` and ``ServeLoop``: a torn body
  answers 400 and the retry lands once, a lost spool submit resolves to an
  ``expired/`` record through the deadline sweep, a lost response is
  re-served; the port's audit passes.

- The three kill and preempt tests of JAX's slow tier, each a pair of port
  CLI subprocesses with a bounded wait, marked ``slow`` as JAX marks them:
  two ``distributed=true`` r21d processes over a list with a corrupt video,
  one SIGTERMed mid-run, then a restart round (the failure journal's POISON
  record, the quarantine skip, every healthy video once); two ``fleet=queue``
  resnet18 workers, the first to hold a claim SIGKILLed, the survivor
  reclaiming its lease and draining the queue; the same kill fired by
  ``worker.kill=kill@n2``, audited by the port's ``audit.py``. Both queue
  runs' ``.npy`` bytes equal an unkilled run's.

Every thread join, HTTP call, terminal wait and subprocess wait here has a
bound.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

#: seed -> plan (JAX tests/test_chaos.py CHAOS_PLANS)
CHAOS_PLANS = {
    0: "seed=0;decode.read=eio@n3",
    1: "seed=1;sink.fsync=eio@n1",
    2: "seed=2;sink.rename=drop@n1",
    3: "seed=3;sink.tmp_write=torn@n1;decode.read=eio@p0.02",
    4: "seed=4;cache.store=eio@n1;cache.lookup=torn@n1",
    5: "seed=5;queue.claim=skew@n1;heartbeat.tick=error@p0.5",
    6: "seed=6;heartbeat.tick=freeze@after1;decode.read=eio@n5",
    7: "seed=7;sink.fsync=eio@n2;queue.claim=eio@n1;"
       "queue.steal_staging=drop@n1",
}

#: seed -> plan (JAX tests/test_chaos.py GATEWAY_CHAOS_PLANS)
GATEWAY_CHAOS_PLANS = {
    30: "seed=30;gateway.read=torn@n1;gateway.spool_submit=enospc@n1;"
        "spool.respond=drop@n1",
    31: "seed=31;gateway.read=stall@n1;gateway.spool_submit=drop@n1",
}

_BASE = ["feature_type=resnet,clip", "resnet.model_name=resnet18",
         "device=cpu", "allow_random_weights=true",
         "on_extraction=save_numpy", "extraction_total=4", "batch_size=8",
         "video_workers=1"]

_MATRIX_BASE = _BASE + [
    "telemetry=true", "metrics_interval_s=0.4", "health=true",
    "fleet=queue", "fleet_lease_s=3",
]

#: seconds any thread join, HTTP call or terminal wait here may take
WAIT_S = 120


@pytest.fixture(scope="module")
def chaos_corpus(sample_video, tmp_path_factory):
    """Two copies of the sample, one clean run of the JAX reference's
    shape (no fleet, no fault) whose bytes every seed is held to, and one
    clean run with the matrix's keys that ``compare`` holds each seed
    to."""
    from video_features_tpu_torch.cli import main as cli_main
    td = tmp_path_factory.mktemp("torch_chaos_matrix")
    videos = []
    for i in range(2):
        dst = td / f"v_mx_{i}.mp4"
        dst.write_bytes(Path(sample_video).read_bytes())
        videos.append(str(dst))
    listfile = td / "videos.txt"
    listfile.write_text("\n".join(videos) + "\n")
    ref = td / "ref"
    cli_main(_BASE + [f"output_path={ref}", f"tmp_path={td / 'tmp_ref'}",
                      f"file_with_video_paths={listfile}"])
    ref_npy = {p.name: p.read_bytes() for p in ref.rglob("*.npy")}
    assert len(ref_npy) >= 4, sorted(ref_npy)  # 2 videos x >= 2 families
    clean = td / "clean"
    cli_main(_MATRIX_BASE + [
        "cache=true", f"cache_dir={td / 'cache_clean'}",
        f"output_path={clean}", f"tmp_path={td / 'tmp_clean'}",
        f"file_with_video_paths={listfile}"])
    return td, listfile, ref_npy, clean


def _run_chaos_seed(chaos_corpus, seed: int) -> None:
    from video_features_tpu_torch import compare_runs
    from video_features_tpu_torch.audit import audit_run
    from video_features_tpu_torch.cli import main as cli_main
    td, listfile, ref_npy, clean = chaos_corpus
    plan = CHAOS_PLANS[seed]
    out = td / f"seed{seed}"
    cache_dir = td / f"cache{seed}"  # per seed: a shared store would let
    # later seeds skip the decode and starve their own faults
    cli_main(_MATRIX_BASE + [
        f"inject={plan}", "cache=true", f"cache_dir={cache_dir}",
        f"output_path={out}", f"tmp_path={td / f'tmp{seed}'}",
        f"file_with_video_paths={listfile}"])
    ok, violations, _notes = audit_run(
        str(out), cache_dir=str(cache_dir), expect_complete=True)
    assert ok, (f"seed {seed} failed the invariant audit — replay with "
                f"inject={plan!r}:\n  " + "\n  ".join(violations))
    got_npy = {p.name: p.read_bytes() for p in out.rglob("*.npy")}
    assert set(got_npy) == set(ref_npy), \
        f"seed {seed}: artifact set diverged (replay with inject={plan!r})"
    for name, data in ref_npy.items():
        assert got_npy[name] == data, \
            (f"seed {seed}: {name} not bit-identical to the clean run "
             f"(replay with inject={plan!r})")
    # the digest, failure and artifact layers; the stage timings of runs
    # this short are noise, so their band is opened wide
    rc, lines = compare_runs.compare(str(clean), str(out), stage_band=1e9)
    assert rc == 0, "\n".join(lines)
    assert lines[-1].startswith("vft-compare: PASS"), lines[-1]


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_matrix_smoke(chaos_corpus, seed):
    """Tier 1: the decode-fault and sink-fsync-fault rows of the matrix,
    audited and bit-identical."""
    _run_chaos_seed(chaos_corpus, seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3, 4, 5, 6, 7])
def test_chaos_matrix(chaos_corpus, seed):
    """The matrix's remaining seeds, as JAX runs them in its slow tier."""
    _run_chaos_seed(chaos_corpus, seed)


def _http(base, method, path, data=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("seed", sorted(GATEWAY_CHAOS_PLANS))
def test_gateway_chaos_matrix(sample_video, tmp_path, seed):
    from video_features_tpu_torch import serve
    from video_features_tpu_torch.audit import audit_run
    from video_features_tpu_torch.config import load_config, sanity_check
    from video_features_tpu_torch.gateway import GatewayServer
    from video_features_tpu_torch.utils import inject

    spool = tmp_path / "spool"
    cfg = load_config("resnet", {
        "model_name": "resnet18", "device": "cpu",
        "allow_random_weights": True, "on_extraction": "save_numpy",
        "extraction_total": 6, "batch_size": 8, "cache": True,
        "cache_dir": str(tmp_path / "cache"), "spool_dir": str(spool),
        "serve_poll_interval_s": 0.05, "metrics_interval_s": 1,
        "output_path": str(tmp_path / "out"),
        "tmp_path": str(tmp_path / "tmp")})
    sanity_check(cfg, require_videos=False)
    plan = inject.arm_for_run(GATEWAY_CHAOS_PLANS[seed])
    loop = gw = t = None
    try:
        loop = serve.ServeLoop(cfg, out_root=str(tmp_path / "out"))
        t = threading.Thread(target=loop.run, daemon=True)
        t.start()
        gw = GatewayServer({"spool_dir": str(spool),
                            "gateway_poll_interval_s": 0.05,
                            "gateway_expire_grace_s": 0.5,
                            "metrics_interval_s": 1}).start()
        base = f"http://127.0.0.1:{gw.port}"
        data = Path(sample_video).read_bytes()

        st, up = _http(base, "POST", "/v1/upload?name=clip.mp4", data)
        if seed == 30:
            # gateway.read=torn@n1: the first body read is cut short — an
            # explicit 400, never a half-ingested inbox file
            assert st == 400 and "torn" in up["error"], up
            assert not list((spool / "inbox").iterdir())
            st, up = _http(base, "POST", "/v1/upload?name=clip.mp4", data)
        # seed 31's stall@n1 only delays this read; either way the upload
        # lands exactly once, content-addressed
        assert st == 201, up

        if seed == 31:
            # gateway.spool_submit=drop@n1: request A's submit is lost;
            # past deadline + grace the gateway writes the terminal
            # expired record itself
            st, a = _http(base, "POST", "/v1/extract", json.dumps(
                {"video_paths": [up["path"]], "timeout_s": 1.0}).encode())
            assert st == 202
            term = serve.wait_response(str(spool), a["id"], timeout_s=WAIT_S)
            assert term["status"] == "deadline_exceeded", term
            assert term["processed"] == 0

        # the surviving request ends done despite the armed faults (seed
        # 30: the first submit's ENOSPC is retried on the next pump pass;
        # the first response write is dropped, so the claim is requeued
        # and re-served off the feature cache)
        st, b = _http(base, "POST", "/v1/extract", json.dumps(
            {"video_paths": [up["path"]], "timeout_s": 240}).encode())
        assert st == 202
        resp = serve.wait_response(str(spool), b["id"], timeout_s=240)
        assert resp["status"] == "done", resp
        if seed == 30:
            assert plan.fired.get("gateway.spool_submit") == 1
            assert plan.fired.get("spool.respond") == 1
    finally:
        if gw is not None:
            gw.stop()
        if loop is not None:
            loop.stop()
        if t is not None:
            t.join(timeout=WAIT_S)
        inject.disarm()
    assert not t.is_alive()
    ok, violations, _notes = audit_run(
        str(tmp_path), cache_dir=str(tmp_path / "cache"),
        expect_complete=True)
    assert ok, (f"gateway seed {seed} failed the audit — replay with "
                f"inject={GATEWAY_CHAOS_PLANS[seed]!r}:\n  "
                + "\n  ".join(violations))


# ---------------------------------------------------------------------------
# The slow tier's kill and preempt tests (JAX tests/test_chaos.py:88-89,
# :244-245, :576-577), each a pair of port CLI subprocesses.
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]
#: the bound on each subprocess wait (JAX's TIMEOUT_S)
TIMEOUT_S = 560
N_HEALTHY = 6


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_DIST_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from video_features_tpu_torch.cli import main
    main([
        "feature_type=r21d", "model_name=r2plus1d_18_16_kinetics",
        "device=cpu", "distributed=true", "cross_video_batching=true",
        "clip_batch_size=4", "stack_size=16", "step_size=16",
        "extraction_fps=2", "allow_random_weights=true",
        "on_extraction=save_numpy",
        "output_path={out}", "tmp_path={tmp}",
        "file_with_video_paths={listfile}",
    ])
    print("WORKER_DONE", {pid})
""")


def _spawn_dist(pid, port, out, tmp, listfile, log_path):
    """One ``distributed=true`` rank of two, through torchrun's variables
    (the port's gloo group reads them); logs to a file, never a pipe."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", RANK=str(pid), OMP_NUM_THREADS="2")
    env.pop("VFT_INJECT", None)
    script = _DIST_WORKER.format(repo=str(REPO), pid=pid, out=out,
                                 tmp=f"{tmp}_{pid}", listfile=listfile)
    log = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-c", script], stdout=log,
                            stderr=subprocess.STDOUT, env=env), log


def _reap(procs, logs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    for log in logs:
        log.close()


@pytest.mark.slow
def test_chaos_distributed_preempt_corrupt_resume(sample_video, tmp_path):
    """Two real ``distributed=true`` processes with cross-video batching,
    one corrupt video in the list, a SIGTERM of one worker mid-run, then a
    restart round on the same output dir: every healthy video once, the
    corrupt one journaled POISON once by its owner and quarantined (not
    re-failed) in round 2, done work skipped."""
    from video_features_tpu_torch.parallel.mesh import local_shard_of_list
    videos = []
    for i in range(N_HEALTHY):
        dst = tmp_path / f"v_chaos_{i:03d}.mp4"
        dst.write_bytes(Path(sample_video).read_bytes())
        videos.append(str(dst))
    corrupt = tmp_path / "v_chaos_corrupt.mp4"
    corrupt.write_bytes(b"\x00\x01mp4 junk that cv2 cannot open" * 64)
    videos.append(str(corrupt))
    listfile = tmp_path / "videos.txt"
    listfile.write_text("\n".join(videos) + "\n")

    shards = [set(local_shard_of_list(videos, host_id=i, num_hosts=2))
              for i in range(2)]
    assert shards[0] and shards[1] and not (shards[0] & shards[1])
    victim = 0 if str(corrupt) not in shards[0] else 1
    corrupt_owner = 1 - victim  # keep the corrupt video on the survivor
    feat_dir = tmp_path / "out" / "r21d" / "r2plus1d_18_16_kinetics"

    def victim_outputs():
        return [p for p in feat_dir.glob("*_r21d.npy")
                if str(tmp_path / p.name.replace("_r21d.npy", ".mp4"))
                in shards[victim]]

    # ---- round 1: both workers up; SIGTERM the victim mid-run ----------
    port = _free_port()
    procs, logs = zip(*(_spawn_dist(pid, port, tmp_path / "out",
                                    tmp_path / "tmp", listfile,
                                    tmp_path / f"r1_worker_{pid}.log")
                        for pid in range(2)))
    try:
        deadline = time.time() + TIMEOUT_S
        while time.time() < deadline:
            if victim_outputs():
                break
            if procs[victim].poll() is not None:
                raise AssertionError(
                    "victim exited before producing output:\n"
                    + (tmp_path / f"r1_worker_{victim}.log").read_text()[
                        -2000:])
            time.sleep(0.1)
        else:
            raise AssertionError("victim produced no output before deadline")
        procs[victim].send_signal(signal.SIGTERM)
        assert procs[victim].wait(timeout=TIMEOUT_S) == 143
        # the survivor finishes its whole shard (the corrupt video failed)
        # and exits cleanly: a dead peer does not take it down
        assert procs[corrupt_owner].wait(timeout=TIMEOUT_S) == 0, \
            (tmp_path / f"r1_worker_{corrupt_owner}.log").read_text()[-2000:]
    finally:
        _reap(procs, logs)

    r1_victim = (tmp_path / f"r1_worker_{victim}.log").read_text()
    assert "SIGTERM: finishing in-flight" in r1_victim
    r1_surv = (tmp_path / f"r1_worker_{corrupt_owner}.log").read_text()
    assert "1 failed" in r1_surv, r1_surv[-1500:]
    done_r1 = {p.name for p in feat_dir.glob("*_r21d.npy")}
    healthy = {Path(v).stem for v in videos if v != str(corrupt)}
    assert 0 < len(done_r1) < len(healthy)  # work genuinely remains

    # the corrupt video retried retry_attempts times by its owner, then
    # journaled once as POISON; no healthy video has a record
    journal_path = feat_dir / "_failures.jsonl"
    assert journal_path.exists(), "terminal failure must be journaled"

    def journal_records():
        return [json.loads(ln) for ln in
                journal_path.read_text().splitlines() if ln.strip()]

    recs = journal_records()
    assert {r["video"] for r in recs} == {str(corrupt)}, recs
    assert len(recs) == 1, recs
    assert recs[0]["category"] == "POISON"
    assert recs[0]["attempts"] == 3  # configs/r21d.yml retry_attempts
    assert recs[0]["host"] and "elapsed_s" in recs[0]
    assert str(corrupt) in shards[corrupt_owner]

    # ---- round 2: restart both on a fresh port -------------------------
    port = _free_port()
    procs, logs = zip(*(_spawn_dist(pid, port, tmp_path / "out",
                                    tmp_path / "tmp2", listfile,
                                    tmp_path / f"r2_worker_{pid}.log")
                        for pid in range(2)))
    try:
        for pid, p in enumerate(procs):
            assert p.wait(timeout=TIMEOUT_S) == 0, \
                (tmp_path / f"r2_worker_{pid}.log").read_text()[-2000:]
    finally:
        _reap(procs, logs)

    for v in videos:
        stem = Path(v).stem
        outs = list(feat_dir.glob(f"{stem}_r21d.npy"))
        if v == str(corrupt):
            assert not outs, "corrupt video must not produce features"
        else:
            assert len(outs) == 1, f"missing features for {stem}"
            arr = np.load(outs[0])
            assert arr.ndim == 2 and arr.shape[1] == 512

    # done work skipped; the corrupt video quarantined by its owner alone
    for pid in range(2):
        text = (tmp_path / f"r2_worker_{pid}.log").read_text()
        assert f"WORKER_DONE {pid}" in text, text[-1500:]
        n_own = len(shards[pid])
        if pid == corrupt_owner:
            assert "is quarantined by" in text, text[-1500:]
            n_skip = len(done_r1 & {Path(v).stem + "_r21d.npy"
                                    for v in shards[pid]})
            assert f"{n_own - 1 - n_skip} extracted, {n_skip} already done, " \
                   f"0 failed, 1 quarantined" in text, text[-1500:]
        else:
            assert "0 failed" in text, text[-1500:]
            assert "quarantined" not in text, text[-1500:]
    recs = journal_records()
    assert len(recs) == 1 and recs[0]["category"] == "POISON", recs


_QUEUE_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from video_features_tpu_torch.cli import main
    main([
        "feature_type=resnet", "model_name=resnet18", "device=cpu",
        "allow_random_weights=true", "on_extraction=save_numpy",
        "extraction_total=6", "batch_size=8", "video_workers=1",
        "telemetry=true", "metrics_interval_s=0.5",
        "fleet=queue", "fleet_lease_s=2",
        "output_path={out}", "tmp_path={tmp}",
        "file_with_video_paths={listfile}",
    ])
    print("QUEUE_WORKER_DONE")
""")

_REF_ARGS = ["feature_type=resnet", "model_name=resnet18", "device=cpu",
             "allow_random_weights=true", "on_extraction=save_numpy",
             "extraction_total=6", "batch_size=8", "video_workers=1"]


def _queue_corpus(sample_video, tmp_path, prefix, n_videos=4):
    videos = []
    for i in range(n_videos):
        dst = tmp_path / f"{prefix}_{i:02d}.mp4"
        dst.write_bytes(Path(sample_video).read_bytes())
        videos.append(str(dst))
    listfile = tmp_path / "videos.txt"
    listfile.write_text("\n".join(videos) + "\n")
    return listfile


def _spawn_queue(tmp_path, idx, out, listfile, inject_env=None):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("VFT_INJECT", None)
    if inject_env:
        env["VFT_INJECT"] = inject_env
    log = open(tmp_path / f"qworker_{idx}.log", "w")
    script = _QUEUE_WORKER.format(repo=str(REPO), out=out,
                                  tmp=f"{tmp_path}/tmp_{idx}",
                                  listfile=listfile)
    return subprocess.Popen([sys.executable, "-c", script], stdout=log,
                            stderr=subprocess.STDOUT, env=env), log


def _assert_equals_an_unkilled_run(tmp_path, out, listfile, n_videos):
    from video_features_tpu_torch.cli import main as cli_main
    ref = tmp_path / "ref"
    cli_main(_REF_ARGS + [f"output_path={ref}",
                          f"tmp_path={tmp_path}/tmp_ref",
                          f"file_with_video_paths={listfile}"])
    ref_npy = {p.relative_to(ref): p.read_bytes()
               for p in ref.rglob("*.npy")}
    queue_npy = {p.relative_to(out): p.read_bytes()
                 for p in out.rglob("*.npy")}
    assert set(ref_npy) == set(queue_npy), "artifact sets diverged"
    assert len({rel for rel in ref_npy
                if str(rel).endswith("_resnet.npy")}) == n_videos
    for rel, data in ref_npy.items():
        assert queue_npy[rel] == data, \
            f"{rel}: killed-and-reclaimed run diverged from the clean run"


@pytest.mark.slow
def test_chaos_queue_worker_kill_lease_reclaim(sample_video, tmp_path):
    """Two ``fleet=queue`` workers share an output dir; the first to hold
    a claim is SIGKILLed (no drain, no final heartbeat). The survivor sees
    the dead worker's lease expire, reclaims it, re-extracts the video
    exactly once and drains the queue, every artifact bit-identical to an
    unkilled run."""
    n_videos = 4
    listfile = _queue_corpus(sample_video, tmp_path, "v_fleet", n_videos)
    out = tmp_path / "out"
    feat_dir = out / "resnet" / "resnet18"
    claimed_root = feat_dir / "_queue" / "claimed"
    procs, logs = zip(*(_spawn_queue(tmp_path, i, out, listfile)
                        for i in range(2)))
    victim = survivor = None
    try:
        deadline = time.time() + TIMEOUT_S
        claim = None
        while time.time() < deadline:
            claims = list(claimed_root.glob("*/*.json"))
            if claims:
                claim = claims[0]
                break
            if all(p.poll() is not None for p in procs):
                raise AssertionError(
                    "both workers exited before claiming:\n" + "".join(
                        (tmp_path / f"qworker_{i}.log").read_text()[-1000:]
                        for i in range(2)))
            time.sleep(0.01)
        assert claim is not None, "no claim appeared before deadline"
        owner_dir = claim.parent.name  # the host id embeds the worker's pid
        victim = next(i for i, p in enumerate(procs)
                      if f"-{p.pid}-" in owner_dir)
        survivor = 1 - victim
        procs[victim].kill()  # SIGKILL: no drain, no final heartbeat
        assert procs[victim].wait(timeout=30) == -signal.SIGKILL
        assert procs[survivor].wait(timeout=TIMEOUT_S) == 0, \
            (tmp_path / f"qworker_{survivor}.log").read_text()[-2000:]
    finally:
        _reap(procs, logs)

    surv_log = (tmp_path / f"qworker_{survivor}.log").read_text()
    assert "QUEUE_WORKER_DONE" in surv_log, surv_log[-1500:]
    # exactly once: one done marker per video, nothing pending or claimed,
    # and the killed worker's item finished by the survivor after a steal
    done = {p.stem: json.loads(p.read_text())
            for p in (feat_dir / "_queue" / "done").glob("*.json")}
    assert len(done) == n_videos, sorted(done)
    assert not list((feat_dir / "_queue" / "pending").glob("*.json"))
    assert not list(claimed_root.glob("*/*.json"))
    reclaimed = [r for r in done.values() if r["reclaims"] >= 1]
    assert reclaimed, "the killed worker's lease was never reclaimed"
    for rec in reclaimed:
        assert f"-{procs[victim].pid}-" not in rec["by"], \
            "a dead worker cannot complete work"
    for rec in done.values():
        assert rec["status"] in ("done", "skipped"), rec
    _assert_equals_an_unkilled_run(tmp_path, out, listfile, n_videos)


@pytest.mark.slow
def test_chaos_inject_worker_kill_replay(sample_video, tmp_path):
    """The same kill as a replayable plan: ``worker.kill=kill@n2`` SIGKILLs
    worker 0 at its second per-video attempt; worker 1 drains the queue,
    the port's audit passes ``--expect-complete`` on the whole dir, and
    the bytes equal an unkilled run's."""
    from video_features_tpu_torch.audit import audit_run
    n_videos = 4
    listfile = _queue_corpus(sample_video, tmp_path, "v_ik", n_videos)
    out = tmp_path / "out"
    feat_dir = out / "resnet" / "resnet18"
    procs, logs = zip(_spawn_queue(tmp_path, 0, out, listfile,
                                   "seed=11;worker.kill=kill@n2"),
                      _spawn_queue(tmp_path, 1, out, listfile))
    try:
        assert procs[0].wait(timeout=TIMEOUT_S) == -signal.SIGKILL, \
            "the injected worker.kill must SIGKILL the victim"
        assert procs[1].wait(timeout=TIMEOUT_S) == 0, \
            (tmp_path / "qworker_1.log").read_text()[-2000:]
    finally:
        _reap(procs, logs)
    victim_log = (tmp_path / "qworker_0.log").read_text()
    assert "INJECT: worker.kill=kill fired" in victim_log

    done = {p.stem: json.loads(p.read_text())
            for p in (feat_dir / "_queue" / "done").glob("*.json")}
    assert len(done) == n_videos, sorted(done)
    assert all(r["status"] in ("done", "skipped") for r in done.values())
    ok, violations, _ = audit_run(str(out), expect_complete=True)
    assert ok, "\n".join(violations)
    _assert_equals_an_unkilled_run(tmp_path, out, listfile, n_videos)
