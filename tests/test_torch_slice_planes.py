"""The i3d + RAFT slice's run-plane and serving keys, and the CLI on the
sample video: split from tests/test_torch_slice.py, whose module fixture
(the JAX and port slices) and these RAFT runs held one xdist worker over
300 s under ``--dist loadfile``. The helpers are that file's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_slice import FPS, REPO, _frames, _overrides
from video_features_tpu_torch import config as tconfig


@pytest.mark.parametrize("key,value", [
    ("compile_cache", True), ("fleet", "queue")])
def test_serving_keys_run_on_the_slice(tmp_path, key, value):
    """The slice's config with the serving plane's keys passes (``fleet=
    queue`` with a file sink and ``telemetry=true``), and the key takes
    effect: the compile cache attaches the slice's entry, which runs the
    RAFT kernels (the build into it is a miss through a stand-in
    ``nvcc``); the queue seeds the slice's video."""
    from video_features_tpu_torch import compile_cache
    from video_features_tpu_torch.kernels import build
    from video_features_tpu_torch.parallel.queue import WorkQueue
    over = dict(_overrides(tmp_path), **{key: value})
    over.update(on_extraction="save_numpy", telemetry=True,
                compile_cache_dir=str(tmp_path / "cc"))
    cfg = tconfig.load_config("i3d", over)
    tconfig.sanity_check(cfg)
    if key == "fleet":
        q = WorkQueue(str(cfg.output_path), host_id="h")
        assert q.seed([cfg.video_paths]) == 1
        assert q.claim_next()["video"] == "synthetic.mp4"
        return
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv[1:]\n"
                    "open(a[a.index('-o') + 1], 'wb').write(b'lib')\n")
    nvcc.chmod(0o755)
    compile_cache.detach_for_tests()
    real = build.nvcc_path
    build.nvcc_path = lambda: str(nvcc)
    try:
        before = compile_cache.snapshot()
        entry = compile_cache.attach_for_args("i3d", cfg)
        assert entry.kernels and entry.family == "i3d"
        assert compile_cache.summary(before)["misses"] == 1
        assert entry.seal() == 2 and entry.is_warm()
    finally:
        build.nvcc_path = real
        compile_cache.detach_for_tests()


@pytest.mark.parametrize("key", ["telemetry", "trace", "health", "parity",
                                 "roofline"])
def test_run_plane_keys_run_on_the_slice(tmp_path, key):
    """The i3d slice's extractor under each key: the config passes and the
    extractor runs it (``health``: the digests land beside the outputs;
    ``telemetry``, ``trace``: the recorder the CLI starts records the
    stages of ``extract_frames``; ``parity``: the observer the CLI starts
    digests the head seam of each output at the sink; ``roofline``: the
    observer counts the group's dispatch, the RAFT lookups' declared work
    among its FLOPs)."""
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    from video_features_tpu_torch.telemetry import health as thealth
    from video_features_tpu_torch.telemetry import jsonl as tjsonl

    over = dict(_overrides(tmp_path), **{key: True,
                                         "on_extraction": "save_numpy"})
    cfg = tconfig.load_config("i3d", over)
    tconfig.sanity_check(cfg)
    assert cfg[key] is True
    tex = ExtractI3D(cfg)
    assert tex.health is (key == "health")
    out = tmp_path / "rec"
    if key == "telemetry":
        from video_features_tpu_torch.telemetry.recorder import \
            TelemetryRecorder
        rec = TelemetryRecorder(str(out)).start()
    elif key == "trace":
        from video_features_tpu_torch.telemetry.trace import TraceRecorder
        rec = TraceRecorder(str(out)).start()
    elif key == "parity":
        from video_features_tpu_torch.telemetry import parity as tparity
        rec = tparity.ParityObserver(str(out))
        tparity._set_active(rec)
    elif key == "roofline":
        from video_features_tpu_torch.telemetry.roofline import \
            RooflineObserver
        rec = RooflineObserver(str(out), default_family="i3d").start()
    try:
        feats = tex.extract_frames(iter(_frames()), FPS)
        tex.action_on_extraction(feats, "synthetic.mp4")
    finally:
        if key == "parity":
            tparity._set_active(None)
        if key != "health":
            rec.close()
    if key == "health":
        recs = list(tjsonl.read_jsonl(
            os.path.join(cfg.output_path, thealth.HEALTH_FILENAME)))
        assert sorted(r["key"] for r in recs) == sorted(feats)
    elif key == "telemetry":
        man = json.loads((out / "_run.json").read_text())
        assert {"h2d", "forward", "write"} <= set(man["stage_totals"])
    elif key == "parity":
        recs = list(tjsonl.read_jsonl(out / "_parity.jsonl"))
        assert sorted((r["seam"], r["key"]) for r in recs) == sorted(
            ("head", k) for k in feats)
    elif key == "roofline":
        from video_features_tpu_torch.kernels.corr_lookup import kernel_work
        fam = json.loads((out / "_roofline.json").read_text())[
            "families"]["i3d"]
        assert fam["dispatches"] == 1 and fam["forward_s"] > 0
        # 2 iterations of the proj lookup over 10 pairs on RAFT's 32x43
        # grid (240x320 resized to 256x341, padded to 256x344)
        proj = kernel_work("proj", 10 * 32 * 43, 0)[1]
        assert fam["flops_total"] > 2 * proj
    else:
        doc = json.loads((out / "_trace.json").read_text())
        assert {"h2d", "forward", "write"} <= {
            e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}


def test_cli_writes_outputs(sample_video, tmp_path):
    """``python -m video_features_tpu_torch`` on the sample video writes
    ``{stem}_{key}.npy`` under ``output_path/i3d`` and skips on rerun."""
    cmd = [sys.executable, "-m", "video_features_tpu_torch",
           "feature_type=i3d", "flow_type=raft", "device=cpu",
           "allow_random_weights=true", "stack_size=10", "step_size=10",
           "extraction_fps=1", "flow_iters=1", "on_extraction=save_numpy",
           f"output_path={tmp_path / 'out'}", f"tmp_path={tmp_path / 'tmp'}",
           f"video_paths={sample_video}"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    stem = Path(sample_video).stem
    out = tmp_path / "out" / "i3d"
    for key in ("rgb", "flow", "fps", "timestamps_ms"):
        assert (out / f"{stem}_{key}.npy").exists(), key
    assert np.load(out / f"{stem}_flow.npy").shape == (1, 1024)
    again = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0 and "skipping" in again.stdout
