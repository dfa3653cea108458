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

Every thread join, HTTP call and terminal wait here has a bound.
"""
import json
import threading
from pathlib import Path

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
