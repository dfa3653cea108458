"""The port's fault-tolerance runtime and key gating against the JAX package.

- Every key of the JAX YAMLs whose plane the port does not run raises
  ``NotImplementedError`` naming its ROADMAP.md Queue 1 item when set away
  from its default, in every ported family; at the default it passes.
  The keys of batching and data parallelism (``distributed``,
  ``mesh_devices``, ``video_workers``, ``cross_video_batching``,
  ``model_parallel``) and of the feature cache (``cache``, ``cache_dir``,
  ``cache_scope``) are ported: each runs at the values JAX accepts. So are
  the run-plane keys (``telemetry``, ``metrics_interval_s``, ``trace``,
  ``health``): each writes its artifact and is rejected at a bad value as
  JAX rejects it.
  Every family dispatches (``vggish`` too).
- ``RetryPolicy`` and ``classify`` agree with the JAX ones (defaults,
  backoff delays under one seeded rng, the category of each exception).
- The CLI on a video that fails (a file that is not a video), in process,
  against the JAX CLI in process, both reading one seeded checkpoint: the
  same number of tries (``retry_attempts``, the YAML default 3), the same
  ``_failures.jsonl`` record fields and verdict, the quarantine skip on a
  rerun, ``retry_failed=true`` trying again and appending a record; and
  both ``main()`` return None. Run as processes, both CLIs exit 0 when a
  video fails.
"""
import contextlib
import io
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from video_features_tpu.utils import faults as jfaults
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.utils import faults as tfaults

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("i3d", "raft", "pwc", "r21d", "s3d", "resnet", "clip")
#: gated keys that only CLIP's YAML carries
CLIP_ONLY_KEYS = {"vision_attn"}


GATED_CASES = [
    ("compile_cache", True, 8), ("compile_cache_dir", "/c", 8),
    ("compilation_cache_dir", "/c", 8), ("fleet", "queue", 8),
    ("fleet_lease_s", 30, 8), ("fleet_max_reclaims", 5, 8),
    ("fleet_canary", True, 8), ("serve_slo_s", 0.5, 8),
    ("vision_attn", "blockwise", 10), ("config", "other.yml", None)]


@pytest.mark.parametrize("key,value,item", GATED_CASES)
def test_gated_keys_raise_naming_their_item(key, value, item):
    assert key in tconfig.GATED_KEYS and tconfig.GATED_KEYS[key][1] == item
    match = "ROADMAP.md Queue 1" + (f" #{item}" if item else "")
    for family in FAMILIES:
        cfg = tconfig.load_config(family)
        tconfig.check_ported(cfg)
        with pytest.raises(NotImplementedError, match=match):
            tconfig.check_ported(tconfig.merge(cfg, tconfig.Config(
                {key: value})))


def test_every_gated_key_is_tested_and_in_every_yaml():
    """``vision_attn`` is in CLIP's YAML alone (as in the JAX YAMLs); every
    other gated key is in every port YAML. None of the parallel keys is
    gated."""
    assert {k for k, _, _ in GATED_CASES} == set(tconfig.GATED_KEYS)
    assert not {k for k, _ in PARALLEL_CASES + CACHE_CASES
                + TELEMETRY_CASES} & set(tconfig.GATED_KEYS)
    for family in FAMILIES:
        missing = set(tconfig.GATED_KEYS) - set(tconfig.load_config(family))
        assert missing == (set() if family == "clip" else CLIP_ONLY_KEYS), \
            family


#: the run-plane keys, at values JAX accepts, with the artifact each
#: makes appear (``metrics_interval_s``, ``history`` and ``alerts`` with
#: ``telemetry=true``)
TELEMETRY_CASES = [
    ("telemetry", True), ("metrics_interval_s", 5), ("trace", True),
    ("health", True), ("parity", True), ("roofline", True),
    ("history", True), ("alerts", True)]
#: the keys that need ``telemetry=true``
ON_TELEMETRY = ("metrics_interval_s", "history", "alerts")


@pytest.mark.parametrize("key,value", TELEMETRY_CASES)
def test_telemetry_keys_run(key, value, tmp_path):
    """Each key passes the port's checks in every family, is rejected at a
    bad value as the JAX package rejects it, and writes its artifact on a
    small resnet18 run of the CLI on the CPU."""
    from video_features_tpu import config as jconfig
    from video_features_tpu_torch.cli import main as tmain

    for family in FAMILIES:
        tconfig.check_ported(tconfig.merge(tconfig.load_config(family),
                                           tconfig.Config({key: value})))
    bad = 0 if key == "metrics_interval_s" else "yes"
    for mod in (tconfig, jconfig):
        cfg = mod.load_config("resnet", {key: bad, "device": "cpu",
                                         "output_path": str(tmp_path / "o"),
                                         "tmp_path": str(tmp_path / "t"),
                                         "video_paths": "a.mp4"})
        with pytest.raises(ValueError, match=key):
            mod.sanity_check(cfg)
    extra = [f"{key}={value}"] + (["telemetry=true"]
                                  if key in ON_TELEMETRY else [])
    with contextlib.redirect_stdout(io.StringIO()):
        tmain(["feature_type=resnet", "model_name=resnet18", "device=cpu",
               "allow_random_weights=true", "extraction_total=2",
               "on_extraction=save_numpy", f"output_path={tmp_path / 'o'}",
               f"tmp_path={tmp_path / 't'}",
               f"video_paths={REPO / 'tests/assets/v_synth_sample.mp4'}"]
              + extra)
    out = tmp_path / "o" / "resnet" / "resnet18"
    made = {p.name for p in out.iterdir() if p.name.startswith("_")}
    want = {"telemetry": {"_telemetry.jsonl", "_run.json"},
            "trace": {"_trace.json"}, "health": {"_health.jsonl"},
            "parity": {"_parity.jsonl"}, "roofline": {"_roofline.json"},
            "history": {"_telemetry.jsonl", "_run.json"},
            "alerts": {"_telemetry.jsonl", "_run.json"}}
    if key == "metrics_interval_s":
        hb = json.loads(next(out.glob("_heartbeat_*.json")).read_text())
        assert hb["interval_s"] == 5.0
    else:
        assert want[key] <= made, made
        assert not ({"_trace.json", "_health.jsonl", "_run.json",
                     "_parity.jsonl", "_roofline.json"}
                    - want[key]) & made, made
        # a sample for each of the first and the final heartbeat at least;
        # the alerts section in the heartbeat, no transition on a clean run
        history = list(out.glob("_history_*.jsonl"))
        assert len(history) == (key in ("history", "alerts")), made
        assert not {"_alerts.jsonl", "_incidents"} & made, made
        if key in ON_TELEMETRY:
            assert len(history[0].read_text().splitlines()) >= 2
            hb = json.loads(next(out.glob("_heartbeat_*.json")).read_text())
            assert ("alerts" in hb) is (key == "alerts")


#: the keys of batching and data parallelism, at values JAX accepts
PARALLEL_CASES = [
    ("distributed", True), ("mesh_devices", 2), ("video_workers", 4),
    ("video_workers", "auto"), ("cross_video_batching", True),
    ("model_parallel", 2)]


def _tiny_clip_checkpoint(path):
    """A seeded heads=1 ViT in OpenAI's key layout (``model_name=custom``
    builds its architecture from the shapes)."""
    from video_features_tpu_torch.models import clip as tclip
    from video_features_tpu_torch.weights.bridge import seeded_init_
    torch.save(seeded_init_(tclip.CLIP(tclip._cfg(128, 32, 2, 64, 16, 64,
                                                   2)), 0).state_dict(), path)
    return path


@pytest.mark.parametrize("key,value", PARALLEL_CASES)
def test_parallel_keys_run(key, value, tmp_path, monkeypatch):
    """Each key passes the port's checks in every family and does what it
    says on a small run on the CPU."""
    import numpy as np
    from video_features_tpu_torch import cli as tcli
    from video_features_tpu_torch.parallel.mesh import local_shard_of_list
    from video_features_tpu_torch.registry import get_extractor_cls

    for family in FAMILIES:
        tconfig.check_ported(tconfig.merge(tconfig.load_config(family),
                                           tconfig.Config({key: value})))
    family = "clip" if key == "model_parallel" else (
        "r21d" if key == "cross_video_batching" else "resnet")
    over = {"device": "cpu", key: value, "on_extraction": "save_numpy",
            "allow_random_weights": True, "model_name": "resnet18",
            "output_path": str(tmp_path / "o"),
            "tmp_path": str(tmp_path / "t")}
    if family == "r21d":
        over.update(model_name="r2plus1d_18_16_kinetics", stack_size=4,
                    step_size=4, clip_batch_size=3)
    if family == "clip":
        over.update(model_name="custom", mesh_devices=4, weights_path=str(
            _tiny_clip_checkpoint(tmp_path / "clip.pt")))
    cfg = tconfig.load_config(family, over)
    tconfig.sanity_check(cfg, require_videos=False)
    assert cfg[key] == value
    if key == "video_workers":
        assert tcli._video_workers(cfg.video_workers) == (
            4 if value == 4 else max(1, min(8, os.cpu_count() // 2)))
    elif key == "distributed":
        import socket
        import torch.distributed as dist
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(port))
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        assert not dist.is_initialized()
        tcli._maybe_init_distributed(cfg)
        try:
            assert dist.get_world_size() == 1 and dist.get_rank() == 0
            tcli._maybe_init_distributed(cfg)  # already in: no second init
            assert local_shard_of_list(["a.mp4", "b.mp4"]) == \
                ["a.mp4", "b.mp4"]
        finally:
            dist.destroy_process_group()
    elif key == "mesh_devices":
        assert get_extractor_cls(family)(cfg).runner.n_devices == 2
    else:
        rng = np.random.default_rng(0)
        frames = [(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8),
                   i * 40.0, i) for i in range(10)]
        ex = get_extractor_cls(family)(cfg)
        got = ex.extract_frames(iter(frames), 25.0)[family]
        default = {"cross_video_batching": False, "model_parallel": 1}[key]
        cfg1 = tconfig.merge(cfg, tconfig.Config({key: default}))
        plain = get_extractor_cls(family)(cfg1)
        want = plain.extract_frames(iter(frames), 25.0)[family]
        if key == "cross_video_batching":
            assert ex._packer is not None and plain._packer is None
            assert got.shape == (2, 512)
        else:
            attn = ex.runner.replicas[0]["model"].visual.transformer \
                .resblocks[0].attn
            assert [tuple(s.in_proj_weight.shape) for s in attn.shards] \
                == [(96, 64)] * 2 and len(ex.runner.replicas) == 2
            with pytest.raises(ValueError, match="must divide"):
                get_extractor_cls(family)(tconfig.merge(
                    cfg, tconfig.Config({"model_parallel": 3})))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


#: the keys of the feature cache, at the values the gated cases used
CACHE_CASES = [("cache", True), ("cache_dir", "c"),
               ("cache_scope", "tenant")]


@pytest.mark.parametrize("key,value", CACHE_CASES)
def test_cache_keys_run(key, value, sample_video, tmp_path, monkeypatch):
    """Each key passes the port's checks in every family and does what it
    says on a small run on the CPU: the first extraction stores one entry
    (under ``cache_dir``, else ``VFT_CACHE_DIR``), a second extractor into
    another output directory is served from it without extracting, and
    under ``cache_scope=tenant`` another tenant's request misses."""
    from video_features_tpu_torch.cache import cache_stats
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    from video_features_tpu_torch.telemetry.context import use_request

    for family in FAMILIES:
        tconfig.check_ported(tconfig.merge(tconfig.load_config(family),
                                           tconfig.Config({key: value})))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VFT_CACHE_DIR", str(tmp_path / "default"))

    def extractor(out):
        cfg = tconfig.load_config("resnet", {
            "cache": True, key: value, "device": "cpu",
            "model_name": "resnet18", "extraction_total": 2,
            "on_extraction": "save_numpy", "allow_random_weights": True,
            "video_paths": sample_video, "output_path": str(tmp_path / out),
            "tmp_path": str(tmp_path / "t")})
        tconfig.sanity_check(cfg)
        return ExtractResNet(cfg)

    with use_request("alpha-r1"), contextlib.redirect_stdout(io.StringIO()):
        feats = extractor("a")._extract(sample_video)
        served = extractor("b")
        served.extract = None  # a hit never extracts
        got = served._extract(sample_video)
    assert got["resnet"].tobytes() == feats["resnet"].tobytes()
    root = tmp_path / ("c" if key == "cache_dir" else "default")
    assert cache_stats(str(root))["families"]["resnet"]["entries"] == 1
    with use_request("beta-r2"):
        other = served.feature_cache().lookup(sample_video)
    assert (other is None) == (key == "cache_scope")


def test_show_pred_is_ported_for_the_clip_stack_families_only():
    """And for the frame-wise families, since they were ported."""
    for family in FAMILIES:
        cfg = tconfig.merge(tconfig.load_config(family),
                            tconfig.Config({"show_pred": True}))
        if family in ("r21d", "s3d", "resnet", "clip"):
            tconfig.check_ported(cfg)
        else:
            with pytest.raises(NotImplementedError, match="show_pred"):
                tconfig.check_ported(cfg)


def test_vggish_is_not_ported():
    """Since vggish was ported the registry rejects no family of the JAX
    package: every one dispatches, and only an unknown name raises."""
    from video_features_tpu_torch.cli import main
    from video_features_tpu_torch.registry import get_extractor_cls
    for family in FAMILIES + ("vggish",):
        assert get_extractor_cls(family).__name__.startswith("Extract")
    with pytest.raises(NotImplementedError, match="Unknown feature_type"):
        main(["feature_type=nosuch", "device=cpu", "video_paths=v.mp4"])


def test_retry_policy_matches_jax():
    cfg = tconfig.load_config("r21d")
    want = jfaults.RetryPolicy.from_config(cfg)
    got = tfaults.RetryPolicy.from_config(cfg)
    assert (got.attempts, got.backoff_s, got.retry_failed) == \
        (want.attempts, want.backoff_s, want.retry_failed) == (3, 0.5, False)
    want.rng, got.rng = random.Random(3), random.Random(3)
    assert [got.backoff_delay(k) for k in range(1, 10)] == \
        [want.backoff_delay(k) for k in range(1, 10)]
    for bad in ({"retry_attempts": 0}, {"retry_backoff_s": -1}):
        with pytest.raises(ValueError):
            tfaults.RetryPolicy.from_config(bad)


@pytest.mark.parametrize("exc", [
    ValueError("Cannot determine fps"), KeyError("k"), IndexError("i"),
    NotImplementedError("x"), TypeError("t"), ImportError("m"),
    RuntimeError("blip"), MemoryError(), OSError(5, "EIO"),
    OSError(28, "No space left on device"), ConnectionError("reset")])
def test_classify_matches_jax(exc):
    assert tfaults.classify(exc) == jfaults.classify(exc)


def r21d_checkpoint(path):
    from video_features_tpu_torch.models.r21d import R2Plus1D
    from video_features_tpu_torch.weights.bridge import seeded_init_
    torch.save(seeded_init_(R2Plus1D(), 0).state_dict(), path)
    return path


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Three in-process runs of each package's CLI on one broken video:
    the first, a rerun, and a rerun with ``retry_failed=true``; per run the
    return value, stdout and the journal's records."""
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain

    tmp = tmp_path_factory.mktemp("faults")
    bad = tmp / "broken.mp4"
    bad.write_bytes(b"not a video")
    ckpt = r21d_checkpoint(tmp / "r21d.pt")
    out = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        root = tmp / name
        base = ["feature_type=r21d", "device=cpu", f"weights_path={ckpt}",
                "on_extraction=save_numpy", "retry_backoff_s=0",
                f"output_path={root / 'o'}", f"tmp_path={root / 't'}",
                f"video_paths={bad}"]
        journal = root / "o" / "r21d" / "r2plus1d_18_16_kinetics" / \
            "_failures.jsonl"
        runs = []
        for extra in ([], [], ["retry_failed=true"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = main(base + extra)
            records = [json.loads(line) for line in
                       journal.read_text().splitlines()]
            runs.append(dict(rc=rc, out=buf.getvalue(), records=records))
        out[name] = runs
    ckpt.unlink()  # 127 MB; the runs are done with it
    return out


def test_failed_video_journal_matches_jax(cli_runs):
    for name, runs in cli_runs.items():
        first = runs[0]
        assert len(first["records"]) == 1, name
        rec = first["records"][0]
        assert rec["category"] == "POISON" and rec["attempts"] == 3, rec
        assert first["out"].count("An error occurred extracting") == 3
    j, t = cli_runs["jax"][0]["records"][0], \
        cli_runs["port"][0]["records"][0]
    assert set(t) == set(j)
    assert (t["category"], t["attempts"], t["error"]) == \
        (j["category"], j["attempts"], j["error"])


def test_rerun_skips_quarantined_video_as_jax(cli_runs):
    for name, runs in cli_runs.items():
        second = runs[1]
        assert "is quarantined by" in second["out"], name
        assert "An error occurred" not in second["out"]
        assert second["records"] == runs[0]["records"]


def test_retry_failed_tries_again_as_jax(cli_runs):
    for name, runs in cli_runs.items():
        third = runs[2]
        assert third["out"].count("An error occurred extracting") == 3, name
        assert len(third["records"]) == 2
        assert third["records"][1]["attempts"] == 3


def test_main_returns_none_as_jax(cli_runs):
    assert [r["rc"] for r in cli_runs["jax"]] == \
        [r["rc"] for r in cli_runs["port"]] == [None] * 3


def test_exit_status_on_failed_video_matches_jax(tmp_path, request):
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video")
    ckpt = r21d_checkpoint(tmp_path / "r21d.pt")
    request.addfinalizer(lambda: ckpt.unlink(missing_ok=True))
    args = ["feature_type=r21d", "device=cpu", f"weights_path={ckpt}",
            "retry_attempts=1", f"output_path={tmp_path / 'o'}",
            f"tmp_path={tmp_path / 't'}", f"video_paths={bad}"]
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    codes = []
    for cmd in ([sys.executable, "-m", "video_features_tpu_torch"],
                [sys.executable, str(REPO / "main.py")]):
        run = subprocess.run(cmd + args, cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
        assert "An error occurred extracting" in run.stdout, run.stderr
        codes.append(run.returncode)
    assert codes == [0, 0]
