"""The port's kernel compile cache (``compile_cache.py``) against the JAX
package's.

The cases of the JAX ``tests/test_compile_cache.py`` on the port: keying
(invariant under non-semantic churn, ``resize=auto`` as its resolution, a
toolchain or card change resolving to another entry), verify-before-trust
(a rotted or unsealed library dropped, never loaded), the first-wins attach
and the warmup-then-extract zero-miss contract across fresh processes; plus
the port's own: the kernel build's hit and miss counts, the per-machine
``compilation_cache_dir``, a family without kernels warm on its manifest
alone, and a flipped library rebuilt. There is no ``nvcc`` here: a fake one
(a script that writes its ``-o`` file) stands in, through
``kernels/build.nvcc_path`` in process and ``CUDA_HOME`` in subprocesses.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from video_features_tpu import compile_cache as jcc
from video_features_tpu_torch import compile_cache as cc
from video_features_tpu_torch.kernels import build

REPO = Path(__file__).resolve().parents[1]

FAKE_NVCC = """#!{python}
import sys
a = sys.argv[1:]
if "--version" in a:
    print("Cuda compilation tools, release 12.4, V12.4.131")
    sys.exit(0)
out = a[a.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"fake kernel library " + " ".join(a).encode())
print("ptxas info    : Compiling entry function '_Z4fakev' for 'sm_90a'")
print("ptxas info    : Used 32 registers")
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    """A ``CUDA_HOME`` whose ``bin/nvcc`` writes its ``-o`` file, set for
    this process (``build.nvcc_path``) and its subprocesses; the attach and
    the build directory restored after."""
    root = tmp_path / "cuda"
    (root / "bin").mkdir(parents=True)
    nvcc = root / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(root))
    # subprocesses keep this worker's share of the cores
    # (tests/test_torch_threads.py)
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    cc.detach_for_tests()
    yield root
    cc.detach_for_tests()
    build.set_build_dir(None)


@pytest.fixture
def cc_detached():
    cc.detach_for_tests()
    yield
    cc.detach_for_tests()
    build.set_build_dir(None)


BASE = {"feature_type": "i3d", "flow_type": "raft", "stack_size": 64,
        "extraction_fps": 4, "batch_size": 16, "on_extraction": "save_numpy",
        "output_path": "./output", "video_workers": 1, "telemetry": False,
        "device": "cuda", "compile_cache": True, "compile_cache_dir": None}


def test_entry_key_invariant_under_non_semantic_churn(tmp_path):
    env = dict(nvcc="12.4", driver="550", device_name="card",
               capability="sm_90")
    _, env_fp = cc.env_fingerprint(**env)
    key = cc.entry_key("i3d", cc.config_fingerprint(BASE), env_fp)
    churned = dict(BASE, output_path=str(tmp_path), video_workers=8,
                   telemetry=True, trace=True, health=True,
                   retry_attempts=5, fleet="queue", fleet_lease_s=5,
                   inject="seed=1;sink.fsync=enospc@n1",
                   compile_cache_dir=str(tmp_path / "cc"),
                   compilation_cache_dir=str(tmp_path / "b"),
                   spool_dir="/s", serve_slo_s=2.0,
                   cache=True, cache_dir=str(tmp_path / "fc"))
    assert cc.entry_key("i3d", cc.config_fingerprint(churned),
                        env_fp) == key
    for semantic in (dict(flow_type="pwc"), dict(extraction_fps=2),
                     dict(device="cpu"), dict(precision="bfloat16")):
        assert cc.entry_key("i3d", cc.config_fingerprint(
            dict(BASE, **semantic)), env_fp) != key
    assert cc.entry_key("raft", cc.config_fingerprint(BASE),
                        env_fp) != key
    # the config fingerprint is the JAX package's (one canonicalization)
    for args in (BASE, churned):
        assert cc.config_fingerprint(args) == jcc.config_fingerprint(args)


@pytest.mark.parametrize("over", [
    {}, {"resize": "host"}, {"on_extraction": "print"}, {"show_pred": True},
    {"ingest": "yuv420"}])
def test_resolved_overlay_makes_auto_equal_its_resolution(over):
    auto = dict(BASE, **{"resize": "auto", **over})
    assert cc.resolved_overlay(auto) == jcc.resolved_overlay(auto)
    explicit = dict(auto, resize=cc.resolved_overlay(auto).get(
        "resize", auto.get("resize")))
    assert cc.config_fingerprint(auto, cc.resolved_overlay(auto)) == \
        cc.config_fingerprint(explicit, cc.resolved_overlay(explicit))


def test_env_fingerprint_misses_on_version_change(tmp_path):
    env, fp = cc.env_fingerprint()
    assert env["torch"] == torch.__version__
    assert set(env) == {"torch", "cuda", "nvcc", "driver", "device_name",
                        "capability", "python"}
    assert env["device_name"] == "cpu"  # no card here
    fps = {fp}
    for change in (dict(torch_version="99.0"), dict(cuda_version="99.9"),
                   dict(nvcc="99.9"), dict(driver="999.1"),
                   dict(device_name="NVIDIA H100 80GB HBM3",
                        capability="sm_90")):
        fps.add(cc.env_fingerprint(**change)[1])
    assert len(fps) == 6
    cfg = cc.config_fingerprint(BASE)
    assert len({cc.CompileCacheEntry(str(tmp_path), "i3d", cfg, f).dir
                for f in fps}) == 6


def _entry(tmp_path, kernels=True) -> cc.CompileCacheEntry:
    entry = cc.CompileCacheEntry(str(tmp_path / "store"), "i3d",
                                 "c" * 64, "e" * 64, kernels=kernels)
    os.makedirs(entry.dir, exist_ok=True)
    return entry


def _lib(entry, name=None, data=None) -> Path:
    path = Path(entry.dir, name or build.library_name())
    path.write_bytes(data if data is not None else os.urandom(256))
    Path(str(path) + ".ptxas.txt").write_text("ptxas info : Used 1 reg")
    return path


def test_seal_then_verify_keeps_sealed_files(tmp_path):
    entry = _entry(tmp_path)
    _lib(entry)
    assert not entry.is_warm()  # unsealed files carry no warm promise
    assert entry.seal() == 2
    assert entry.is_warm()
    assert entry.verify() == {"verified": 2, "dropped": 0}
    assert entry.is_warm()
    man = entry.manifest()
    assert man["schema"] == cc.SCHEMA_VERSION == jcc.SCHEMA_VERSION
    assert man["files"] == 2 and man["kernels"] is True


def test_corrupt_sealed_library_dropped_not_served(tmp_path):
    entry = _entry(tmp_path)
    lib = _lib(entry)
    entry.seal()
    lib.write_bytes(os.urandom(256))  # bit rot: same size, other bytes
    assert entry.verify() == {"verified": 0, "dropped": 1}
    assert not lib.exists()
    assert not Path(str(lib) + ".ptxas.txt").exists()  # with its report
    assert not entry.is_warm()


def test_unsealed_file_dropped_at_attach(tmp_path):
    entry = _entry(tmp_path)
    _lib(entry)
    entry.seal()
    orphan = _lib(entry, "libvft_kernels_0000000000000000.so")
    assert entry.verify() == {"verified": 2, "dropped": 1}
    assert not orphan.exists()
    assert entry.is_warm()


def test_stale_sources_library_carries_no_warm_promise(tmp_path):
    """A sealed entry whose library is another sources digest's is not
    warm: the current sources would build."""
    entry = _entry(tmp_path)
    _lib(entry, "libvft_kernels_ffffffffffffffff.so")
    entry.seal()
    assert entry.verify()["dropped"] == 0 and not entry.is_warm()


def test_family_without_kernels_is_trivially_warm(tmp_path):
    entry = _entry(tmp_path, kernels=False)
    assert not entry.is_warm()
    assert entry.seal() == 0
    assert entry.is_warm()
    for family, over, want in (
            ("i3d", {}, True), ("i3d", {"flow_type": "pwc"}, False),
            ("i3d", {"streams": "rgb"}, False), ("raft", {}, True),
            ("raft", {"corr_lookup_impl": "gather"}, False),
            ("resnet", {}, False), ("pwc", {}, False)):
        assert cc.runs_kernels(family, dict(BASE, **over)) is want, \
            (family, over)


def test_resolve_root_semantics(tmp_path, monkeypatch):
    monkeypatch.delenv("VFT_COMPILE_CACHE_DIR", raising=False)
    assert cc.resolve_root({"compile_cache": False}) is None
    # auto is off on the CPU without an explicit dir, on for cuda runs
    assert cc.resolve_root({"compile_cache": "auto",
                            "device": "cpu"}) is None
    assert cc.resolve_root({"compile_cache": "auto"}) is None
    assert cc.resolve_root({"compile_cache": "auto", "device": "cuda:0"}) \
        == cc.default_root()
    assert cc.resolve_root({"compile_cache": "auto", "device": "cpu",
                            "compile_cache_dir": str(tmp_path)}) \
        == str(tmp_path)
    monkeypatch.setenv("VFT_COMPILE_CACHE_DIR", str(tmp_path / "envroot"))
    assert cc.resolve_root({"compile_cache": True}) == \
        str(tmp_path / "envroot")
    with pytest.raises(ValueError, match="compile_cache"):
        cc.resolve_root({"compile_cache": "bogus"})


def test_attach_is_first_wins_process_global(tmp_path, fake_cuda):
    args = dict(BASE, compile_cache_dir=str(tmp_path / "store"))
    before = cc.snapshot()
    entry = cc.attach("i3d", args)
    assert entry is not None and cc.active() is entry
    # the attach built the kernels into the entry: one miss
    assert cc.summary(before) == {"hits": 0, "misses": 1,
                                  "nvcc_s": pytest.approx(
                                      cc.summary(before)["nvcc_s"])}
    assert Path(entry.dir, build.library_name()).exists()
    assert build.library_path() == Path(entry.dir, build.library_name())
    again = cc.attach("raft", dict(BASE, feature_type="raft",
                                   compile_cache_dir=str(tmp_path / "b")))
    assert again is entry
    info = cc.active_info()
    assert info["family"] == "i3d" and not info["warm_at_attach"]
    cc.detach_for_tests()
    assert cc.active() is None


def test_build_counts_hits_misses_and_the_build_dir(tmp_path, fake_cuda):
    """Without an entry the library lands in ``compilation_cache_dir``
    (``kernels/_build/`` by default): nvcc once (a miss), then hits."""
    cc.configure_build_dir({"compilation_cache_dir": str(tmp_path / "b")})
    assert build.library_path() == tmp_path / "b" / build.library_name()
    before = cc.snapshot()
    lib = build.build()
    assert lib.exists() and build.report_path(lib).exists()
    build.build()
    build.build()
    s = cc.summary(before)
    assert (s["hits"], s["misses"]) == (2, 1) and s["nvcc_s"] > 0
    assert build.kernel_resources(build.report_path(lib).read_text()) == {
        "_Z4fakev": {"smem_bytes": 0, "registers": 32}}
    cc.configure_build_dir({"compilation_cache_dir": "auto"})
    assert build.library_path() == build.BUILD_DIR / build.library_name()


def test_flipped_library_rebuilt_never_loaded(tmp_path, fake_cuda):
    args = dict(BASE, compile_cache_dir=str(tmp_path / "store"))
    entry = cc.attach("i3d", args)
    assert entry.seal() == 2
    lib = Path(entry.dir, build.library_name())
    good = lib.read_bytes()
    flipped = bytearray(good)
    flipped[0] ^= 0xFF
    lib.write_bytes(bytes(flipped))
    cc.detach_for_tests()
    before = cc.snapshot()
    entry = cc.attach("i3d", args)
    assert (entry.verified, entry.dropped) == (0, 1)  # its report went too
    assert not entry.warm_at_attach
    assert (cc.summary(before)["hits"], cc.summary(before)["misses"]) == \
        (0, 1)
    rebuilt = lib.read_bytes()  # rebuilt: the flipped bytes are gone
    assert rebuilt != bytes(flipped) and rebuilt.startswith(good[:20])
    entry.seal()
    cc.detach_for_tests()
    before = cc.snapshot()
    entry = cc.attach("i3d", args)
    assert entry.warm_at_attach and entry.verified == 2
    assert (cc.summary(before)["hits"], cc.summary(before)["misses"]) == \
        (1, 0)


def test_heartbeat_and_manifest_sections_carry_the_counts(tmp_path,
                                                          fake_cuda):
    from video_features_tpu_torch.telemetry.recorder import TelemetryRecorder
    baseline = cc.snapshot()
    cc.attach("i3d", dict(BASE, compile_cache_dir=str(tmp_path / "s")))
    rec = TelemetryRecorder(str(tmp_path / "out"),
                            compile_cache_baseline=baseline)
    hb = rec.build_heartbeat()["compile_cache"]
    assert (hb["hits"], hb["misses"], hb["family"]) == (1 - 1, 1, "i3d")
    assert set(hb) >= {"entry", "warm_at_attach", "verified", "dropped"}
    assert rec.build_manifest()["compile_cache"]["misses"] == 1
    plain = TelemetryRecorder(str(tmp_path / "out2"))
    assert plain.build_heartbeat()["compile_cache"]["misses"] == 0


def _warm_result(proc) -> dict:
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("VFT_WARMUP_RESULT ")]
    assert lines, (proc.stdout + proc.stderr)[-2000:]
    return json.loads(lines[-1][len("VFT_WARMUP_RESULT "):])


def test_warmup_then_extract_zero_miss(sample_video, tmp_path, fake_cuda):
    """``warmup`` builds and seals the triple; a fresh CLI process over the
    same semantic config then reports hits >= 1 and misses == 0."""
    store = tmp_path / "store"
    keys = {"device": "cpu", "flow_type": "raft", "stack_size": 10,
            "step_size": 10, "extraction_fps": 1, "flow_iters": 2,
            "allow_random_weights": True, "compile_cache_dir": str(store)}
    warm = subprocess.run(
        [sys.executable, "-c", cc._WARMUP_WORKER, "i3d", json.dumps(keys)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    result = _warm_result(warm)
    assert result["status"] == "ok", result
    assert result["compiled"] == 1 and result["sealed_files"] == 2
    assert not result["warm_before"]
    argv = ["feature_type=i3d"] + [
        f"{k}={str(v).lower() if isinstance(v, bool) else v}"
        for k, v in keys.items()] + [
        "on_extraction=save_numpy", "telemetry=true",
        f"output_path={tmp_path / 'out'}", f"tmp_path={tmp_path / 'tmp'}",
        f"video_paths={sample_video}"]
    run = subprocess.run(
        [sys.executable, "-m", "video_features_tpu_torch", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert run.returncode == 0, (run.stdout + run.stderr)[-2000:]
    assert "compile cache: entry" in run.stdout and "(warm" in run.stdout
    summary = json.loads((tmp_path / "out" / "i3d" / "_run.json")
                         .read_text())["compile_cache"]
    assert summary["misses"] == 0 and summary["hits"] >= 1, summary
    assert summary["warm_at_attach"] is True
    # the warmup entry point itself: a second warmup is a re-verify
    again = subprocess.run(
        [sys.executable, "-m", "video_features_tpu_torch", "warmup",
         "feature_type=i3d"] + [a for a in argv[1:] if a.split("=")[0]
                                in keys],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "warm already, re-verified" in again.stdout
