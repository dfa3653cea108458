"""The port's trace report (``video_features_tpu_torch/trace_report.py``)
against the JAX package's ``scripts/trace_report.py``.

- The four cases of JAX ``tests/test_trace.py`` on the port's module, run
  as ``python -m video_features_tpu_torch.trace_report``: the decode-bound
  verdict and the ranked stall on a synthetic timeline, ``--merge`` of a
  device capture (pids disjoint, both rebased to t=0), ``--merge`` of two
  anchored traces onto shared wall time (and the anchorless fallback), and
  the clear errors on a torn, missing and non-trace file.
- On the same ``_trace.json`` (the synthetic one, and a real port CLI run
  with ``trace=true``): ``stage_summary``, ``critical_path``,
  ``utilization_table`` and ``top_stalls`` equal to JAX's.
- ``--merge`` of the run's real CPU ``torch.profiler`` capture
  (``profile_trace_dir=``): the merged file holds the capture's lanes (its
  string pids and tids, its metadata events) and the host lanes under a
  pid above every integer pid of the capture, ``"aligned": false``, both
  rebased to t=0.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from video_features_tpu_torch import trace_report as tr

REPO = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "jax_trace_report", REPO / "scripts" / "trace_report.py")
jtr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtr)


def _write_trace(path, events, dropped=0):
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"schema": "vft.trace/1", "dropped_events": dropped}}
    path.write_text(json.dumps(doc))
    return path


def _report(args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "video_features_tpu_torch.trace_report"]
        + [str(a) for a in args], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120)


def _x(name, ts, dur, tid, args=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
         "tid": tid}
    if args:
        e["args"] = args
    return e


#: JAX tests/test_trace.py's synthetic timeline: a decode-heavy video on a
#: fanout bus thread, with one injected stall
SYNTHETIC = [
    {"ph": "M", "name": "process_name", "pid": 1,
     "args": {"name": "vft-host"}},
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 10,
     "args": {"name": "vft-fanout-decode"}},
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 20,
     "args": {"name": "vft-family-resnet"}},
    _x("video_attempt", 0, 100_000, 20, {"video": "a.mp4", "attempt": 1}),
    _x("decode", 0, 80_000, 10),            # bus lane: pure decode
    _x("decode", 10_000, 5_000, 20),        # family lane: transform
    _x("forward", 20_000, 10_000, 20),
    _x("write", 90_000, 2_000, 20),
    _x("fanout.get_starved", 40_000, 30_000, 20, {"family": "resnet"}),
]


def test_trace_report_verdict_and_stalls(tmp_path):
    p = _report([_write_trace(tmp_path / "_trace.json", SYNTHETIC)])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "verdict: decode-bound" in p.stdout
    assert "fanout.get_starved" in p.stdout
    assert "a.mp4" in p.stdout
    assert "vft-fanout-decode" in p.stdout
    # accepts the run directory too
    assert _report([tmp_path]).returncode == 0


def test_trace_report_merge_host_device(tmp_path):
    """--merge splices a device capture found under a directory with the
    host trace into one file, pids disjoint, both rebased to t=0."""
    host = _write_trace(tmp_path / "_trace.json", [
        {"ph": "X", "name": "decode", "ts": 5_000_000, "dur": 100,
         "pid": 7, "tid": 1},
    ])
    dev_dir = tmp_path / "capture"
    dev_dir.mkdir()
    (dev_dir / "host_7.1000.pt.trace.json").write_text(json.dumps(
        {"traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 3,
             "args": {"name": "cuda:0"}},
            {"ph": "X", "name": "fusion.1", "ts": 9_000_000, "dur": 50,
             "pid": 3, "tid": 2}]}))
    p = _report([host, "--merge", dev_dir, "--out", tmp_path / "m.json"])
    assert p.returncode == 0, p.stdout + p.stderr
    merged = json.load(open(tmp_path / "m.json"))
    xs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == {"decode", "fusion.1"}
    assert len({e["pid"] for e in xs}) == 2  # host pid remapped, disjoint
    assert min(e["ts"] for e in xs) == 0  # both rebased


def test_trace_report_merge_wall_clock_anchors(tmp_path):
    """Two port traces whose recorders started 3 s apart merge onto shared
    wall time; an anchorless second input falls back to both at t=0."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir(), b_dir.mkdir()
    host = a_dir / "_trace.json"
    host.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "decode", "ts": 100.0, "dur": 10.0,
         "pid": 7, "tid": 1}],
        "otherData": {"schema": "vft.trace/1", "start_unix": 1000.0}}))
    (b_dir / "_trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "decode", "ts": 100.0, "dur": 10.0,
         "pid": 7, "tid": 1}],
        "otherData": {"schema": "vft.trace/1", "start_unix": 1003.0}}))
    p = _report([host, "--merge", b_dir, "--out", tmp_path / "m.json"])
    assert p.returncode == 0, p.stdout + p.stderr
    merged = json.load(open(tmp_path / "m.json"))
    assert merged["otherData"]["aligned"] is True
    xs = sorted(e["ts"] for e in merged["traceEvents"] if e.get("ph") == "X")
    assert xs == [100.0, 100.0 + 3e6]
    (b_dir / "_trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "fusion.1", "ts": 9_000_000, "dur": 50,
         "pid": 3, "tid": 2}]}))
    p2 = _report([host, "--merge", b_dir, "--out", tmp_path / "m2.json"])
    assert p2.returncode == 0, p2.stdout + p2.stderr
    merged2 = json.load(open(tmp_path / "m2.json"))
    assert merged2["otherData"]["aligned"] is False
    assert min(e["ts"] for e in merged2["traceEvents"]
               if e.get("ph") == "X") == 0


def test_trace_report_truncated_file_clear_error(tmp_path):
    torn = tmp_path / "_trace.json"
    torn.write_text('{"traceEvents": [{"ph": "X", "name": "dec')  # torn
    p = _report([torn])
    assert p.returncode != 0
    err = p.stdout + p.stderr
    assert "not a complete JSON trace" in err
    assert "Traceback" not in err  # a message, not a JSON traceback
    p2 = _report([tmp_path / "absent"])
    assert p2.returncode != 0 and "trace=true" in (p2.stdout + p2.stderr)
    notrace = tmp_path / "x.json"
    notrace.write_text('{"foo": 1}')
    p3 = _report([notrace])
    assert p3.returncode != 0
    assert "traceEvents" in (p3.stdout + p3.stderr)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, sample_video):
    """A port CLI run of resnet18 on the sample with ``trace=true`` and a
    ``torch.profiler`` capture: (output dir, capture dir, stdout)."""
    from video_features_tpu_torch.cli import main
    tmp = tmp_path_factory.mktemp("trace_cli")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["feature_type=resnet", "model_name=resnet18", "device=cpu",
              "allow_random_weights=true", "extraction_total=3",
              "on_extraction=save_numpy", "trace=true",
              f"profile_trace_dir={tmp / 'prof'}",
              f"output_path={tmp / 'out'}", f"tmp_path={tmp / 'tmp'}",
              f"video_paths={sample_video}"])
    return tmp / "out" / "resnet" / "resnet18", tmp / "prof", buf.getvalue()


@pytest.mark.parametrize("which", ["synthetic", "cli"])
def test_summaries_equal_jax(tmp_path, cli_run, which):
    if which == "synthetic":
        path = str(_write_trace(tmp_path / "_trace.json", SYNTHETIC))
    else:
        path = str(cli_run[0] / "_trace.json")
    assert tr.stage_summary(path) == jtr.stage_summary(path)
    doc, _ = tr.load_host_trace(path)
    names = tr.thread_names(doc["traceEvents"])
    xs = tr.complete_events(doc["traceEvents"])
    assert names == jtr.thread_names(doc["traceEvents"])
    assert tr.critical_path(xs, names) == jtr.critical_path(xs, names)
    assert tr.utilization_table(xs, names) == jtr.utilization_table(xs,
                                                                     names)
    for top in (1, 10):
        assert tr.top_stalls(xs, top) == jtr.top_stalls(xs, top)
    if which == "cli":
        # a real run attributes busy time and gives a verdict
        assert tr.stage_summary(path)["verdict"].endswith("-bound")


def test_cli_points_at_the_report_and_merges_its_capture(cli_run, tmp_path):
    out_dir, prof, stdout = cli_run
    captures = list(prof.glob("*.pt.trace.json"))
    assert len(captures) == 1
    assert "video_features_tpu_torch.trace_report" in stdout
    assert f"--merge {captures[0]}" in stdout
    p = _report([out_dir, "--merge", prof, "--out", tmp_path / "m.json"])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "verdict: " in p.stdout
    merged = json.load(open(tmp_path / "m.json"))
    assert merged["otherData"]["aligned"] is False
    capture = json.loads(captures[0].read_text())
    host = json.loads((out_dir / "_trace.json").read_text())
    events = merged["traceEvents"]
    assert len(events) == len(capture["traceEvents"]) + len(
        host["traceEvents"])
    int_pids = [e["pid"] for e in capture["traceEvents"]
                if isinstance(e.get("pid"), int)]
    host_pid = max(int_pids) + 100000
    host_lanes = events[len(capture["traceEvents"]):]
    assert {e["pid"] for e in host_lanes} == {host_pid}
    assert {e["name"] for e in host_lanes if e.get("ph") == "X"} >= {
        "video_attempt", "forward"}
    # the capture's own lanes pass through: string pids and tids, metadata
    dev_lanes = events[:len(capture["traceEvents"])]
    assert any(isinstance(e.get("pid"), str) for e in dev_lanes)
    assert any(e.get("ph") == "M" for e in dev_lanes)
    for lanes in (dev_lanes, host_lanes):
        assert min(e["ts"] for e in lanes if "ts" in e) == 0
    # the file handed over directly merges the same way
    p2 = _report([out_dir, "--merge", captures[0], "--out",
                  tmp_path / "m2.json"])
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert json.load(open(tmp_path / "m2.json")) == merged


def test_newest_capture_is_merged(tmp_path, capsys):
    for ms in (1000, 3000, 2000):
        (tmp_path / f"h_1.{ms}.pt.trace.json").write_text(json.dumps(
            {"traceEvents": [{"ph": "X", "name": f"k{ms}", "ts": 1.0,
                              "dur": 1.0, "pid": 0, "tid": "stream 7"}]}))
    doc = tr.load_profile_capture(str(tmp_path))
    assert doc["traceEvents"][0]["name"] == "k3000"
    assert "3 captures" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="profile_trace_dir"):
        tr.load_profile_capture(str(tmp_path / "absent"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="profile_trace_dir"):
        tr.load_profile_capture(str(tmp_path / "empty"))
