"""chip_smoke.py's traffic and chaos phases (steps 25-26) on the CPU at a
small size: the traffic phase stub-served at the YAMLs' speedups and serving
the slice for real on a tiny scenario, and the chaos phase over two copies of
the sample. A file of its own beside tests/test_torch_chip_smoke.py, whose
module fixtures already take several minutes on one xdist worker, so the
two run on different workers. The script is imported without running
``main()``."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: the CPU's small sizes of the slice (tests/test_torch_chip_smoke.py
#: SMALL): one 10-frame stack, 2 RAFT iterations
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1)


#: ``compare``'s noise floor for the chaos runs' stage timings here: on a
#: CPU shared by the suite's workers a stage under 5 s in all (cv2's
#: sub-millisecond grabs: 0.10 against 0.81 ms a call failed one run at
#: 1.5x) is the scheduler's, not the run's; the forward stage, seconds a
#: call, stays held to the band
CPU_STAGE_FLOOR_S = 5.0


#: a drill small enough to serve the slice for real on the CPU: 6 requests
#: over 2 corpus items in 3 wall seconds
TINY_SCENARIO = """
scenario: tiny_real
seed: 5
duration_s: 3
clock: wall
slo_s: 600
curve_windows: 2
arrivals:
  process: constant
  rate_rps: 1.5
corpus:
  n_items: 2
  zipf_s: 0.0
tenants:
  alpha:
    key: alpha-k
    rate_rps: 10
    burst: 10
objectives:
  - min_completed: 1
"""


@pytest.fixture(scope="module")
def drill_phases(tmp_path_factory, sample_video):
    """The traffic phase stub-served at the YAMLs' speedups, the traffic
    phase serving the slice for real on a tiny scenario (held against a
    ``cli.main`` run of the sample), and the chaos phase, on the CPU at
    :data:`SMALL` in one working directory."""
    from video_features_tpu_torch.kernels import corr_lookup as cl
    work = tmp_path_factory.mktemp("drills")
    (work / "tiny.yml").write_text(TINY_SCENARIO)
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    mp.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    try:
        cs.run_cli(cs.telemetry_argv("ref", sample_video, **SMALL), cl)
        stub = cs.traffic_phase(
            video=sample_video, speedup=None, stub_s=0.002,
            duration_scale=cs.TRAFFIC_DURATION_SCALE, **SMALL)
        real = cs.traffic_phase(video=sample_video,
                                scenarios=(str(work / "tiny.yml"),),
                                speedup=1.0, reference="ref/out/i3d",
                                **SMALL)
        chaos = cs.chaos_phase(video=sample_video,
                               compare_min_stage_s=CPU_STAGE_FLOOR_S,
                               **SMALL)
        yield dict(stub=stub, real=real, chaos=chaos)
    finally:
        mp.undo()


def test_traffic_phase_runs_stub_served_on_the_cpu(drill_phases):
    """steady and burst_shed at their own speedups against a 2 ms stub
    service, cut to the card's schedules (15 s of steady's 30, 10 s of
    burst_shed's 40): the journal is the dry run's (held inside the
    phase), the tallies reconcile, steady passes, beta is shed, every
    audit passes."""
    stats = drill_phases["stub"]
    assert list(stats) == ["steady", "burst_shed"]
    steady, burst = stats["steady"], stats["burst_shed"]
    assert (steady["speedup"], burst["speedup"]) == (30.0, 40.0)
    assert (steady["duration_s"], burst["duration_s"]) == (15.0, 10.0)
    assert (steady["offered"], burst["offered"]) == (18, 34)
    assert steady["verdict"] == "PASS" and steady["admitted"] == 18
    assert burst["tenants"]["beta"]["rejected"] >= 3
    for drill in stats.values():
        assert drill["audit"]["pass"] is True
        assert drill["audit_command"]["verdict"] == "PASS"
        assert drill["launches"] == {"level": 0, "proj": 0, "packed": 0}
        assert drill["items_served"] == 6
        assert drill["latency"]["wait"]["p99"] is not None
    json.dumps(stats)


def test_traffic_phase_serves_the_slice_on_the_cpu(drill_phases):
    """The slice served for real: each corpus item (the sample and a
    suffix) decodes to features bit-equal to ``cli.main``'s on the sample
    (held inside the phase); the hits decode nothing."""
    drill = drill_phases["real"]["tiny_real"]
    assert drill["verdict"] == "PASS"
    assert drill["completed"] == drill["offered"] == 6
    assert drill["items_served"] == 2 and drill["stacks_per_item"] == 1
    # two cold items decode the sample each; the four hits decode nothing
    assert drill["frames_decoded"] > 0
    assert drill["frames_decoded"] % 2 == 0
    assert drill["audit_command"]["verdict"] == "PASS"


def test_chaos_phase_runs_on_the_cpu(drill_phases):
    """Clean and seeds 0 and 1 over two copies of the sample: bit-equal
    outputs, every audit passes, compare passes, the selftest passes."""
    stats = drill_phases["chaos"]
    runs = stats["runs"]
    assert list(runs) == ["clean", "seed0", "seed1"]
    assert runs["seed0"]["plan"] == "seed=0;decode.read=eio@n3"
    for name, run in runs.items():
        assert run["audit"]["verdict"] == "PASS"
        assert run["launches"] == {"level": 0, "proj": 0, "packed": 0}
        if name != "clean":
            assert run["compare"].startswith("vft-compare: PASS")
    assert stats["npy_files"] == 8  # 2 videos x rgb, flow, fps, timestamps
    assert stats["selftest"].startswith("compare_runs selftest OK")
    json.dumps(stats)
