"""chip_smoke.py's steps 27-30 on the CPU at a small size: blockwise attention
and CLIP's ``vision_attn`` (a 577-token primitive, ViT-B/32 through the
extractor), ``show_pred`` on i3d RAFT, raft and pwc, the trace report over a
telemetry run with a ``torch.profiler`` capture, and a ``fleet=queue``
worker killed by ``worker.kill=kill@n2``. A file of its own beside the other
chip-smoke test files, whose module fixtures already take minutes each on
one xdist worker. The script is imported without running ``main()``; no
lookup kernel runs on the CPU, so every count it holds is 0 here."""
import importlib.util
import json
import shutil
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: the CPU's small sizes of the slice (tests/test_torch_chip_smoke_run_plane
#: .py SMALL): one 10-frame stack, 2 RAFT iterations
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1)
NO_LAUNCH = {"level": 0, "proj": 0, "packed": 0}
#: the kill step's corpus on the CPU: the victim finishes the first video
#: and dies at the second, which the survivor reclaims
KILL_VIDEOS = 2


def test_sequence_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """A 577-token primitive (two block boundaries) in the band, causal
    and not; ViT-B/32 dense and blockwise through the extractor in the
    band, no lookup launch, no device numbers off the card."""
    monkeypatch.chdir(tmp_path)
    stats = cs.sequence_phase(model_name="ViT-B/32", n_frames=3, batch=2,
                              shape=(2, 577, 2, 8), device="cpu")
    assert set(stats["primitives"]) == {"full", "causal"}
    for prim in stats["primitives"].values():
        assert prim["max_abs_err"] <= cs.SEQUENCE_ATOL
        assert prim["dense_ms"] is None and prim["blockwise_ms"] is None
    assert set(stats["runs"]) == {"dense", "blockwise"}
    for run in stats["runs"].values():
        assert run["launches"] == NO_LAUNCH and run["frames_per_s"] > 0
        assert run["max_memory_allocated"] is None
    assert stats["features_max_abs"] <= cs.SEQUENCE_ATOL
    assert stats["block_size"] == 256
    json.dumps(stats)


def test_show_pred_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """i3d RAFT with show_pred over two 10-frame stacks: features equal to
    the run without it, the four ``At stack`` tables, logits within the
    band of the plain lookup's; raft and pwc show one overlay per flow,
    each flow image the frame's shape and dtype."""
    monkeypatch.chdir(tmp_path)
    stats = cs.show_pred_phase(stack=10, iters=2, raft_frames=3,
                               pwc_frames=3, device="cpu")
    i3d = stats["i3d"]
    assert i3d["launches"] == i3d["features_only_launches"] == NO_LAUNCH
    assert len(i3d["top5"]) == 4 and i3d["flow_forwards"] >= 1
    # the plain lookup on both sides off the card: every row compared
    assert i3d["logits_max_abs_vs_plain_lookup"] == 0.0
    assert i3d["top5_compared"] == 4 and min(i3d["top6_min_gaps"]) > 0
    for family in ("raft", "pwc"):
        assert stats[family]["flows"] == 2
        assert stats[family]["launches"] == NO_LAUNCH
        assert stats[family]["image_shape"] == [cs.FRAME_H, cs.FRAME_W, 3]
        assert stats[family]["image_dtype"] == "uint8"
    json.dumps(stats)


@pytest.fixture(scope="module")
def plane_runs(tmp_path_factory, sample_video):
    """In one working directory: a telemetry run of the slice at
    :data:`SMALL` with ``trace=true`` and a capture, laid out as the
    telemetry phase's on run; :data:`KILL_VIDEOS` copies of the sample as
    the fleet phase lays them out, and their static run; then the
    trace-report and worker-kill steps over them."""
    from video_features_tpu_torch.kernels import corr_lookup as cl
    work = tmp_path_factory.mktemp("model_paths")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    # the kill step's subprocesses keep this worker's share of the cores
    mp.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    try:
        root = cs.TELEMETRY_ROOT
        cs.run_cli(cs.telemetry_argv(f"{root}/on", sample_video, **SMALL)
                   + ["telemetry=true", "trace=true",
                      f"profile_trace_dir={root}/prof"], cl)
        report = cs.trace_report_phase(proj_want=0)
        copies = cs.fleet_corpus(sample_video, KILL_VIDEOS)
        Path(cs.FLEET_ROOT).mkdir(parents=True)
        for copy in copies:
            shutil.copyfile(sample_video, copy)
        cs.run_cli(cs.fleet_keys(f"{cs.FLEET_ROOT}/single", copies,
                                 fleet="static", **SMALL), cl)
        kill = cs.worker_kill_phase(video=sample_video,
                                    n_videos=KILL_VIDEOS, **SMALL)
        yield dict(report=report, kill=kill)
    finally:
        mp.undo()


def test_trace_report_phase_runs_on_the_cpu(plane_runs):
    """A verdict printed and in ``stage_summary``; the merged file holds
    both inputs' events, the host lanes under one pid, not aligned, and no
    device kernel off the card."""
    stats = plane_runs["report"]
    assert stats["verdict"].endswith("-bound")
    assert stats["stage_summary"]["verdict"] == stats["verdict"]
    assert stats["merged_events"] == stats["host_events"] + stats[
        "capture_events"]
    assert stats["device_kernels"] == 0 and stats["aligned"] is False
    json.dumps(stats)


def test_worker_kill_phase_runs_on_the_cpu(plane_runs):
    """The victim dies by the plan's SIGKILL at its second video; the
    survivor reclaims that lease and drains the queue; the outputs equal
    the static run's and the audit passes."""
    stats = plane_runs["kill"]
    assert stats["victim_exit"] == -9 and stats["done_by_victim"] == 1
    assert stats["reclaimed"].endswith(".mp4")
    assert stats["audit"]["verdict"] == "PASS"
    json.dumps(stats)
