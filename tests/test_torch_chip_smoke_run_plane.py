"""chip_smoke.py's run-plane phases (steps 17-19) on the CPU at a small size:
the telemetry and alerts phases and the fleet step, and the storage phase's
audit of their trees. A file of its own, split from
tests/test_torch_chip_smoke.py: its module fixture takes minutes, so xdist's
``--dist loadfile`` runs it on a worker apart from the serving phases
(tests/test_torch_chip_smoke_serving.py). The script is imported without
running ``main()``."""
import importlib.util
import json
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


#: the telemetry test's small sizes: one 10-frame stack, 2 RAFT iterations
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1)


@pytest.fixture(scope="module")
def run_plane_phases(tmp_path_factory, sample_video):
    """The telemetry and alerts phases and the fleet step over both roots,
    on the CPU at :data:`SMALL` in one working directory (the alerts
    phase's cost turns at the 0.3 s interval only)."""
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp_path_factory.mktemp("run_plane"))
    try:
        telemetry = cs.telemetry_phase(video=sample_video, **SMALL)
        alerts = cs.alerts_phase(video=sample_video, intervals=(0.3,),
                                 **SMALL)
        fleet = cs.fleet_step({"telemetry": "output/chip_smoke/telemetry",
                               "alerts": cs.ALERTS_ROOT})
        yield dict(telemetry=telemetry, alerts=alerts, fleet=fleet)
    finally:
        mp.undo()


def test_telemetry_phase_runs_on_the_cpu(run_plane_phases):
    """The telemetry phase on the CPU at a small size (one 10-frame stack,
    2 RAFT iterations): the run plane on and off give equal features, and
    every artifact checks; no lookup kernel runs on the CPU."""
    stats = run_plane_phases["telemetry"]
    assert stats["max_abs_on_vs_off"] == 0.0 and stats["stacks"] == 1
    assert stats["proj_launches"] == {"off": 0, "on": 0, "capture_off": 0,
                                      "repeat": 0}
    assert stats["health_records"] == 4
    assert {"decode", "h2d", "forward", "write"} <= set(
        stats["stage_totals"])
    assert stats["topology_device_name"] is None
    assert stats["profiler_trace_bytes"] > 0
    # roofline and parity on: counted on the CPU, no peak resolved there
    # (measure_peak needs a card), records at i3d's three seams, live
    # sections; the repeat run times its second, uncounted dispatch alone
    for run in ("on", "capture_off", "repeat"):
        doc = stats["roofline"][run]
        assert doc["device"]["source"] == "unresolved"
        assert doc["flops_total"] > 0 and doc["mfu"] is None
    assert stats["roofline"]["repeat"]["flops_total"] == stats["roofline"][
        "capture_off"]["flops_total"]
    assert isinstance(stats["counting_pass_s"], float)
    assert {s for s, n in stats["parity_seams"].items() if n} == set(
        cs.I3D_SEAMS)
    assert stats["heartbeat_parity"]["records"] == sum(
        stats["parity_seams"].values())
    assert stats["heartbeat_roofline"]["families"]["i3d"]["dispatches"] == 1
    # history and alerts on the on runs: at least the first and the final
    # sample (a run slower than the 30 s interval adds a tick's), no alert;
    # the last sample's MFU the heartbeat's (None on the CPU)
    for run in ("on", "capture_off", "repeat"):
        plane = stats["alert_plane"][run]
        assert plane["samples"] >= 2 and plane["transitions"] == []
        assert plane["last_mfu"] == {"i3d": None}


def test_alerts_phase_and_fleet_step_run_on_the_cpu(run_plane_phases):
    """The alerts phase at the small size: the fault run fires one
    ``failure_spike`` with a verified bundle holding the live roofline
    summary, then resolves; the cost turns keep their features and write
    no history with the keys off; one tick's evaluation timed. The fleet
    step over both roots; the printed line's keys. No proj launch on the
    CPU."""
    stats = run_plane_phases["alerts"]
    fault = stats["fault"]
    assert fault["proj_launches"] == 0
    assert fault["transitions"] == [("failure_spike", "firing"),
                                    ("failure_spike", "resolved")]
    assert fault["history_samples"] >= 2
    assert fault["bundle_roofline_device"]["device_kind"] == "cpu"
    # the run's trace is written at its exit, after the alert fired
    assert {"alert.json", "roofline.json"} <= set(fault["bundle_paths"])
    assert "trace_window.json" not in fault["bundle_paths"]
    assert fault["bundle_artifacts"] == len(fault["bundle_paths"])
    assert fault["bundle_bytes"] > 0
    assert set(stats["walls_s"]) == {"0.3"}
    # one off and one on turn an interval
    assert {k: len(v) for k, v in stats["walls_s"]["0.3"].items()} == {
        "off": 1, "on": 1, "span_off": 1, "span_on": 1}
    assert sorted(stats["planes"]) == ["0.3_on1"]
    assert stats["eval_ms_per_tick"] > 0 and stats["eval_errors"] == 0
    fleet = run_plane_phases["fleet"]
    for root in ("telemetry", "alerts"):
        assert fleet[root]["hosts"] >= 2 and fleet[root]["prom_series"]
        assert fleet[root]["roofline_device"] == "cpu"
        assert fleet[root]["stitched_lanes"] == fleet[root]["hosts"]
    line = cs.alerts_plane_line(run_plane_phases["telemetry"], stats,
                                "card, 700 W")
    assert set(line) == {
        "card", "history_samples", "transitions", "bundle_artifacts",
        "bundle_bytes", "eval_ms_per_tick", "observe_root_ms", "walls_s",
        "mfu_regression_on_clean_runs"}
    assert line["mfu_regression_on_clean_runs"] == []
    assert set(line["history_samples"]) == {
        "telemetry_on", "telemetry_capture_off", "telemetry_repeat",
        "turn_0.3_on1", "fault"}
    json.dumps(line)


def test_storage_audits_the_run_plane_trees(run_plane_phases):
    """The storage phase's audit over the telemetry and alerts phases'
    trees: the port's ``audit --expect-complete`` passes each with 0
    violations, as the JAX audit does."""
    from video_features_tpu.audit import audit_run
    verdicts = cs.audit_trees({k: cs.STORAGE_TREES[k]
                               for k in ("telemetry", "alerts")})
    assert {v["verdict"] for v in verdicts.values()} == {"PASS"}
    for name in ("telemetry", "alerts"):
        ok, _, notes = audit_run(cs.STORAGE_TREES[name]["audit"],
                                 expect_complete=True)
        assert ok and len(notes) == verdicts[name]["notes"], name
