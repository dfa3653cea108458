"""The port's run-plane telemetry against the JAX package's.

One module fixture runs each package's CLI in process on the vendored
sample video, i3d with ``flow_type=raft`` (``flow_iters=2``, 10-frame
stacks, ``extraction_fps=1``: one stack), both reading one set of seeded
weights: checkpoints in the reference's layout written by the port's seeded
init (``weights/bridge.py seeded_init_``) and read by both through their
weights paths. Both run with ``telemetry=true trace=true health=true
profile=true history=true alerts=true``; the port also with
``profile_trace_dir`` (a ``torch.profiler`` trace), and once more with
every one of these keys off. The checkpoints are removed when the fixture
tears down.

Held, with the tolerances stated where there are any:
  - the field tuples, the span vocabulary and the metric registry equal the
    JAX package's, and the port's schema files are the JAX files;
  - the port's span, health and trace records validate under the JAX
    package's ``telemetry/schema.py`` with its schema files and field
    tuples;
  - the span's status, attempts, stage names, event kinds and artifact keys
    equal JAX's; the heartbeat's and the manifest's keys equal JAX's;
  - on the same numpy array, the digests and ``content_signature`` equal
    (all but the wall-clock ``time``); the same observations give the same
    ``prometheus_text``; the same stage observations the same
    ``StageProfiler`` summary; torn-tail healing appends alike;
  - ``scripts/telemetry_report.py`` and ``scripts/trace_report.py`` (JAX
    side readers) render the port's output directory with exit 0;
  - with every key on, the port's features equal its features with them
    off bit for bit, and JAX's within the value tier (atol 1e-2);
  - ``profile=true`` prints the stage summary; ``profile_trace_dir`` holds a
    Chrome trace that parses;
  - ``history`` and ``alerts``: the JAX package's readers (``aggregate``,
    ``read_history``, ``observe_root``, ``current_alerts``) agree with the
    port's on the port's tree; each package's report renders both runs;
    the keys are out of ``config.GATED_KEYS`` and a bad value, or either
    without ``telemetry=true``, raises as JAX's does; a resnet18 run with
    an injected ``sink.fsync`` ENOSPC fires one ``failure_spike`` with a
    bundle both packages verify, and resolves (JAX's
    ``tests/test_alerts.py`` acceptance test, ported).
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from video_features_tpu.telemetry import health as jhealth
from video_features_tpu.telemetry import metrics as jmetrics
from video_features_tpu.telemetry import names as jnames
from video_features_tpu.telemetry import schema as jschema
from video_features_tpu.telemetry import spans as jspans
from video_features_tpu.telemetry import trace as jtrace
from video_features_tpu.telemetry import jsonl as jjsonl
from video_features_tpu.utils import profiling as jprofiling
from video_features_tpu_torch.telemetry import health as thealth
from video_features_tpu_torch.telemetry import jsonl as tjsonl
from video_features_tpu_torch.telemetry import metrics as tmetrics
from video_features_tpu_torch.telemetry import names as tnames
from video_features_tpu_torch.telemetry import spans as tspans
from video_features_tpu_torch.telemetry import trace as ttrace
from video_features_tpu_torch.utils import profiling as tprofiling

REPO = Path(__file__).resolve().parents[1]
SAMPLE = REPO / "tests" / "assets" / "v_synth_sample.mp4"
STEM = SAMPLE.stem
KEYS = ("rgb", "flow", "fps", "timestamps_ms")
ON = ["telemetry=true", "trace=true", "health=true", "profile=true",
      "history=true", "alerts=true"]


def _cli(main, argv):
    """``main(argv)`` in process; its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and the port's runs with the keys on and off: for each,
    its output dir (``.../i3d``), stdout and, for the port's on run, the
    profile trace dir."""
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain
    from video_features_tpu_torch.models import i3d as ti3d
    from video_features_tpu_torch.models import raft as traft
    from video_features_tpu_torch.weights.bridge import seeded_init_

    tmp = tmp_path_factory.mktemp("telemetry")
    ckpt = {"weights_path": (ti3d.I3D(400, in_channels=3), 31),
            "flow_weights_path": (ti3d.I3D(400, in_channels=2), 32),
            "flow_model_weights_path": (traft.RAFT(2), 33)}
    paths = []
    for key, (net, seed) in ckpt.items():
        paths.append(tmp / f"{key}.pt")
        torch.save(seeded_init_(net, seed).state_dict(), paths[-1])
    base = ["feature_type=i3d", "device=cpu", "flow_type=raft",
            "flow_iters=2", "stack_size=10", "step_size=10",
            "extraction_fps=1", "on_extraction=save_numpy",
            f"video_paths={SAMPLE}"] + [
        f"{k}={p}" for k, p in zip(ckpt, paths)]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        for name, main, extra in (
                ("jax", jmain, ON),
                ("port", tmain, ON + [f"profile_trace_dir={tmp / 'prof'}"]),
                ("port_off", tmain, [])):
            root = tmp / name
            stdout = _cli(main, base + extra + [
                f"output_path={root / 'o'}", f"tmp_path={root / 't'}"])
            out[name] = dict(dir=root / "o" / "i3d", stdout=stdout)
        out["port"]["prof"] = tmp / "prof"
        yield out
    finally:
        mp.undo()
        # the JAX CLI leaves its process-global profiler on after profile=true
        jprofiling.profiler.enabled = False
        jprofiling.profiler.reset()
        for p in paths:
            p.unlink(missing_ok=True)


def _span(run) -> dict:
    recs = list(tjsonl.read_jsonl(run["dir"] / "_telemetry.jsonl"))
    assert len(recs) == 1, recs
    return recs[0]


def _health(run) -> list:
    return list(tjsonl.read_jsonl(run["dir"] / "_health.jsonl"))


def _trace(run) -> dict:
    return json.loads((run["dir"] / "_trace.json").read_text())


# -- the contracts ----------------------------------------------------------

@pytest.mark.parametrize("port,jax", [
    (tspans.SPAN_FIELDS, jspans.SPAN_FIELDS),
    (tspans.STATUSES, jspans.STATUSES),
    (tspans.MAX_SPAN_EVENTS, jspans.MAX_SPAN_EVENTS),
    (thealth.HEALTH_FIELDS, jhealth.HEALTH_FIELDS),
    (thealth.SIG_GRID, jhealth.SIG_GRID),
    (ttrace.REQUIRED_X_FIELDS, jtrace.REQUIRED_X_FIELDS),
    (ttrace.REQUIRED_I_FIELDS, jtrace.REQUIRED_I_FIELDS),
    (ttrace.REQUIRED_C_FIELDS, jtrace.REQUIRED_C_FIELDS),
    (ttrace.REQUIRED_M_FIELDS, jtrace.REQUIRED_M_FIELDS),
    (ttrace.KNOWN_SPAN_NAMES, jtrace.KNOWN_SPAN_NAMES),
    (ttrace.STALL_SPAN_NAMES, jtrace.STALL_SPAN_NAMES),
    (ttrace.MAX_EVENTS_PER_THREAD, jtrace.MAX_EVENTS_PER_THREAD),
    (tnames.METRICS, jnames.METRICS),
    (tmetrics.LATENCY_BUCKETS, jmetrics.LATENCY_BUCKETS),
    (tmetrics.FPS_BUCKETS, jmetrics.FPS_BUCKETS),
], ids=["span_fields", "statuses", "max_span_events", "health_fields",
        "sig_grid", "x_fields", "i_fields", "c_fields", "m_fields",
        "span_names", "stall_names", "max_events", "metrics",
        "latency_buckets", "fps_buckets"])
def test_contract_equals_jax(port, jax):
    assert port == jax


@pytest.mark.parametrize("name,fields", [
    ("video_span.schema.json", tspans.SPAN_FIELDS),
    ("feature_health.schema.json", thealth.HEALTH_FIELDS)])
def test_schema_files_are_jax_files(name, fields):
    """Everything but the description (which names its own checker) is
    the JAX file's, and the properties are the emitter's field tuple."""
    port = json.loads((REPO / "video_features_tpu_torch" / "telemetry" /
                       name).read_text())
    jax = json.loads((REPO / "video_features_tpu" / "telemetry" /
                      name).read_text())
    port.pop("description")
    jax.pop("description")
    assert port == jax
    assert tuple(port["properties"]) == fields


def test_every_emitted_metric_name_is_registered():
    """Every ``vft_*`` name the port hands to a metric call is registered
    (the JAX package's VFT005 rule, over the port's tree)."""
    import re
    call = re.compile(r"(?:inc|observe|gauge_set|counter|gauge|histogram)"
                      r"\(\s*[\"'](vft_[a-z0-9_]+)[\"']")
    seen = set()
    for path in (REPO / "video_features_tpu_torch").rglob("*.py"):
        seen |= set(call.findall(path.read_text()))
    assert seen and not seen - set(tnames.METRICS), seen - set(
        tnames.METRICS)
    assert all(k.endswith("_total") for k, v in tnames.METRICS.items()
               if v == "counter")


# -- the CLI runs -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["span", "health", "trace"])
def test_port_records_validate_under_jax_schemas(runs, kind):
    run = runs["port"]
    if kind == "span":
        rec = _span(run)
        assert set(rec) == set(jspans.SPAN_FIELDS)
        assert jschema.validate(rec, jschema.load_span_schema()) == []
    elif kind == "health":
        recs = _health(run)
        assert sorted(r["key"] for r in recs) == sorted(KEYS)
        for rec in recs:
            assert set(rec) == set(jhealth.HEALTH_FIELDS)
            assert jhealth.validate_health(rec) == []
            assert rec["nan"] == rec["inf"] == 0
    else:
        doc = _trace(run)
        assert doc["otherData"]["schema"] == jtrace.TRACE_SCHEMA
        required = {"X": jtrace.REQUIRED_X_FIELDS,
                    "i": jtrace.REQUIRED_I_FIELDS,
                    "C": jtrace.REQUIRED_C_FIELDS,
                    "M": jtrace.REQUIRED_M_FIELDS}
        for ev in doc["traceEvents"]:
            assert all(k in ev for k in required[ev["ph"]]), ev
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {"decode", "h2d", "forward", "write", "health",
                "video_attempt", "prefetch.next"} <= names, names
        assert names - {"decode", "h2d", "forward", "write", "health"} \
            <= set(jtrace.KNOWN_SPAN_NAMES)


def test_span_matches_jax(runs):
    port, jax = _span(runs["port"]), _span(runs["jax"])
    for key in ("status", "attempts", "category", "error", "decode_mode",
                "feature_type", "video_fps", "video_frames",
                "ladder_steps", "request_id", "decode_shared_ms"):
        assert port[key] == jax[key], key
    assert port["status"] == "done" and port["attempts"] == 1
    assert sorted(port["stages"]) == sorted(jax["stages"]) == \
        ["decode", "forward", "h2d", "health", "write"]
    assert all(v["s"] > 0 and v["calls"] > 0
               for v in port["stages"].values())
    # forward's calls follow each package's runners (JAX chains the i3d
    # streams' programs, the port runs both in one forward)
    for key in ("h2d", "health", "write"):
        assert port["stages"][key]["calls"] == \
            jax["stages"][key]["calls"], key

    def kinds(rec):
        return [e["kind"] for e in rec["events"]]

    def artifacts(rec):
        return sorted((e["key"], e["file"], e["bytes"])
                      for e in rec["events"] if e["kind"] == "artifact")
    assert kinds(port) == kinds(jax)
    assert artifacts(port) == artifacts(jax)
    assert [k for k, _, _ in artifacts(port)] == sorted(KEYS)


def test_artifact_digests_describe_the_files(runs):
    """Each ``artifact`` event's size and sha256 are those of the file on
    disk."""
    import hashlib
    rec = _span(runs["port"])
    events = [e for e in rec["events"] if e["kind"] == "artifact"]
    assert len(events) == len(KEYS)
    for e in events:
        data = (runs["port"]["dir"] / e["file"]).read_bytes()
        assert e["bytes"] == len(data)
        assert e["sha256"] == hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("artifact", ["heartbeat", "manifest"])
def test_heartbeat_and_manifest_keys_equal_jax(runs, artifact):
    def load(run):
        if artifact == "manifest":
            return json.loads((run["dir"] / "_run.json").read_text())
        hbs = sorted(run["dir"].glob("_heartbeat_*.json"))
        assert len(hbs) == 1, hbs
        return json.loads(hbs[0].read_text())
    port, jax = load(runs["port"]), load(runs["jax"])
    assert set(port) == set(jax)
    if artifact == "heartbeat":
        assert port["final"] is True and port["videos"] == {"done": 1}
        assert port["host_id"] == jax["host_id"]
        assert set(port["cache"]) == set(jax["cache"])
        assert set(port["fanout"]) == set(jax["fanout"])
    else:
        assert port["tally"] == jax["tally"] == {
            "done": 1, "skipped": 0, "error": 0, "quarantined": 0}
        assert sorted(port["stage_totals"]) == sorted(jax["stage_totals"])
        assert port["health"] == jax["health"]
        assert port["topology"]["platform"] == "cpu"
        assert "device_name" in port["topology"]
        assert not any(k.startswith(("jax", "flax"))
                       for k in port["versions"])
        assert {"torch", "torch_cuda", "cudnn", "numpy"} <= \
            set(port["versions"])
        names = {s["name"] for s in port["metrics"]["series"]}
        assert names == {s["name"] for s in jax["metrics"]["series"]}


@pytest.mark.parametrize("script", ["telemetry_report.py", "trace_report.py"])
def test_jax_side_reports_render_port_output(runs, script):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, str(REPO / "scripts" / script),
                          str(runs["port"]["dir"])], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.strip()


@pytest.mark.parametrize("key", KEYS)
def test_features_equal_with_telemetry_off(runs, key):
    """Bit for bit against the port's run with every key off; within the
    value tier of JAX's on the same weights."""
    name = f"{STEM}_{key}.npy"
    on = np.load(runs["port"]["dir"] / name)
    off = np.load(runs["port_off"]["dir"] / name)
    assert on.tobytes() == off.tobytes() and on.shape == off.shape
    np.testing.assert_allclose(on, np.load(runs["jax"]["dir"] / name),
                               atol=1e-2, rtol=0)


def test_keys_off_write_no_telemetry(runs):
    files = sorted(p.name for p in runs["port_off"]["dir"].iterdir())
    assert files == sorted(f"{STEM}_{k}.npy" for k in KEYS)
    assert "[profile:" not in runs["port_off"]["stdout"]


def test_profile_prints_the_stage_summary(runs):
    out = runs["port"]["stdout"]
    assert "[profile: i3d x 1 videos] total accounted:" in out
    for stage in ("decode", "h2d", "forward", "write", "health"):
        assert any(line.split()[:1] == [stage]
                   for line in out.splitlines()), stage
    assert "telemetry: " in out and "trace: " in out and "health: " in out


def test_profile_trace_dir_holds_a_chrome_trace(runs):
    traces = list(runs["port"]["prof"].glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    doc = json.loads(traces[0].read_text())
    ops = {e.get("name") for e in doc["traceEvents"]
           if e.get("cat") == "cpu_op"}
    assert ops, "no CPU operators traced"
    assert f"profile trace: {traces[0]}" in runs["port"]["stdout"]


# -- helpers on the same inputs ---------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    bad = x.copy()
    bad[0, :3] = [np.nan, np.inf, -np.inf]
    return {"f32": x, "f64": x.astype(np.float64), "nonfinite": bad,
            "int": np.arange(12, dtype=np.int64).reshape(3, 4),
            "scalar": np.array(19.62), "empty": np.zeros((0, 3)),
            "object": np.array([{"a": 1}], dtype=object)}


@pytest.mark.parametrize("name", list(_arrays()))
def test_health_digest_equals_jax(name):
    arr = _arrays()[name]
    port = thealth.digest_array("k", arr, video="v.mp4", feature_type="i3d")
    jax = jhealth.digest_array("k", arr, video="v.mp4", feature_type="i3d")
    port.pop("time")
    jax.pop("time")
    assert port == jax
    assert thealth.content_signature(arr) == jhealth.content_signature(arr)


def test_nonfinite_feature_is_refused_like_jax(tmp_path):
    feats = {"rgb": _arrays()["nonfinite"]}
    errs = []
    for mod, sub in ((thealth, "port"), (jhealth, "jax")):
        with pytest.raises(mod.NonFiniteFeatureError) as e:
            mod.check_features(feats, "v.mp4", "i3d", str(tmp_path / sub))
        errs.append(str(e.value))
        recs = list(tjsonl.read_jsonl(tmp_path / sub / "_health.jsonl"))
        assert [(r["nan"], r["inf"]) for r in recs] == [(1, 2)]
    assert errs[0] == errs[1]
    from video_features_tpu.utils import faults as jfaults
    from video_features_tpu_torch.utils import faults as tfaults
    assert tfaults.classify(thealth.NonFiniteFeatureError("x")) == \
        jfaults.classify(jhealth.NonFiniteFeatureError("x")) == tfaults.POISON


def _observe(reg, kind):
    if kind == "counters":
        reg.counter("vft_videos_total", status="done").inc(3)
        reg.counter("vft_failures_total", category="POISON").inc()
    elif kind == "gauges":
        reg.gauge("vft_fanout_queue_depth", family='r"21d').set(7)
        reg.gauge("vft_uptime_seconds").inc(2.5)
    else:
        h = reg.histogram("vft_stage_seconds", stage="decode")
        for v in (0.0004, 0.003, 0.2, 7.0, 1e4):
            h.observe(v)
        reg.histogram("vft_video_processed_fps",
                      buckets=tmetrics.FPS_BUCKETS).observe(33.0)


@pytest.mark.parametrize("kind", ["counters", "gauges", "histograms"])
def test_metrics_and_prometheus_text_equal_jax(kind):
    port, jax = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _observe(port, kind)
    _observe(jax, kind)
    assert port.to_dict() == jax.to_dict()
    assert tmetrics.prometheus_text(port.to_dict()) == \
        jmetrics.prometheus_text(jax.to_dict())
    name = next(s["name"] for s in port.to_dict()["series"])
    for reg in (port, jax):  # one name, one kind
        with pytest.raises(ValueError, match="already registered"):
            (reg.gauge if kind != "gauges" else reg.counter)(name, x="1")


def test_stage_profiler_summary_and_hooks_equal_jax():
    outs = []
    for mod in (tprofiling, jprofiling):
        prof = mod.StageProfiler()
        seen, traced = [], []
        prof.set_hook(lambda n, dt: seen.append(n))
        prof.set_trace_hook(lambda n, t0, dt: traced.append(n))
        with prof.stage("decode"):
            pass
        prof.enabled = True
        for name, dt in (("decode", 0.25), ("forward", 1.5), ("write", 0.1),
                         ("forward", 0.5)):
            prof.add(name, dt)
        snap = prof.drain()
        assert prof.snapshot() == {}
        for name, (t, n) in snap.items():
            prof.add(name, t, n)
        outs.append((prof.summary("profile"), seen, traced))
    assert outs[0] == outs[1]
    assert outs[0][1] == outs[0][2] == ["decode"]


def test_trace_recorder_caps_a_thread_and_counts_the_rest(tmp_path):
    """Past ``max_events_per_thread`` events are dropped and counted, and
    the file is written once, at close, like JAX's."""
    docs = []
    for mod in (ttrace, jtrace):
        r = mod.TraceRecorder(str(tmp_path / mod.__name__),
                              max_events_per_thread=3).start()
        for i in range(5):
            mod.instant("cache.hit", n=i)
        with mod.span("video_attempt", video="v.mp4"):
            pass
        assert not (tmp_path / mod.__name__ / "_trace.json").exists()
        r.close()
        assert mod.active() is None
        docs.append(json.loads((tmp_path / mod.__name__ /
                                "_trace.json").read_text()))
    for doc in docs:
        assert doc["otherData"]["dropped_events"] == 3
        assert [e.get("args") for e in doc["traceEvents"]
                if e["ph"] == "i"] == [{"n": 0}, {"n": 1}, {"n": 2}]
    assert ttrace.span("x") is ttrace.NOOP_TRACE_SPAN


def test_trace_capture_fails_without_device_activity(tmp_path,
                                                    monkeypatch):
    """On a card, a capture that traced kernel launches but no device
    activity (CUPTI did not start) fails the run; its trace is still
    written. Here a CPU operator stands in for the launch."""
    monkeypatch.setattr(tprofiling.TraceCapture, "_LAUNCHES",
                        ("aten::ones",))
    cap = tprofiling.TraceCapture(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUPTI did not start"):
        with cap:
            cap._cuda = True  # as on a card
            torch.ones(3).sum()
    assert cap.path is not None and Path(cap.path).exists()


def test_trace_capture_is_a_noop_without_a_dir(tmp_path):
    with tprofiling.TraceCapture(None) as cap:
        torch.ones(2).sum()
    assert cap.path is None and not list(tmp_path.iterdir())


@pytest.mark.parametrize("torn", [False, True])
def test_append_jsonl_heals_like_jax(tmp_path, torn):
    for mod, name in ((tjsonl, "port"), (jjsonl, "jax")):
        path = tmp_path / f"{name}.jsonl"
        mod.append_jsonl(path, {"a": 1})
        if torn:
            with open(path, "ab") as f:
                f.write(b'{"b": 2')
        mod.append_jsonl(path, {"c": [1, 2]})
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
    assert list(tjsonl.read_jsonl(tmp_path / "port.jsonl")) == \
        [{"a": 1}, {"c": [1, 2]}]


def test_span_is_carried_onto_the_prefetch_thread():
    """The decode-ahead thread observes stages into the consumer's span."""
    from video_features_tpu_torch.utils.io import Prefetcher
    span = tspans.VideoSpan("v.mp4")
    threads = set()

    def produce():
        for i in range(3):
            threads.add(threading.get_ident())
            tspans.current_span().observe_stage("decode", 0.5)
            yield i

    with span:
        assert list(Prefetcher(produce(), depth=1)) == [0, 1, 2]
    assert threading.get_ident() not in threads
    assert span.record["stages"] == {"decode": {"s": 1.5, "calls": 3}}
    assert span.record["status"] == "error"  # nobody annotated one


def test_recorder_degrades_a_failed_span_write_like_jax(tmp_path,
                                                        monkeypatch):
    """An ENOSPC on ``_telemetry.jsonl`` turns the span channel off and
    counts one write failure; the videos' counters go on."""
    import errno

    from video_features_tpu.telemetry import recorder as jrec
    from video_features_tpu_torch.telemetry import recorder as trec

    def enospc(path, rec):
        raise OSError(errno.ENOSPC, "No space left on device")
    counts = []
    for mod, jmod in ((trec, tjsonl), (jrec, jjsonl)):
        monkeypatch.setattr(jmod, "append_jsonl", enospc)
        r = mod.TelemetryRecorder(str(tmp_path / mod.__name__))
        for status in ("done", "error"):
            with contextlib.redirect_stdout(io.StringIO()):
                r.emit_span({"status": status, "wall_s": 1.0,
                             "video": "v.mp4"})
        series = {(s["name"], tuple(sorted(s["labels"].items()))):
                  s.get("value") for s in r.registry.to_dict()["series"]
                  if s["kind"] == "counter"}
        counts.append(series)
        assert r._spans_disabled
    assert counts[0] == counts[1]
    assert counts[0][("vft_telemetry_write_failures_total",
                      (("pillar", "spans"),))] == 1.0


def test_multi_family_run_records_each_family(tmp_path):
    """A multi-family CLI run (resnet18 + r21d over one decode) with the
    run plane on: one span per family at the output root, each valid under
    the JAX schema, ``done``, attributed ``decode_shared_ms``; the fan-out
    counters in the heartbeat; the pass and each family's job in the trace;
    a rerun counts one cache bypass per family."""
    from video_features_tpu_torch.cli import main as tmain

    argv = ["feature_type=resnet,r21d", "device=cpu",
            "allow_random_weights=true", "on_extraction=save_numpy",
            "resnet.model_name=resnet18", "resnet.extraction_total=4",
            "r21d.extraction_fps=1", "r21d.stack_size=10",
            "r21d.step_size=10", f"output_path={tmp_path / 'o'}",
            f"tmp_path={tmp_path / 't'}", f"video_paths={SAMPLE}",
            "telemetry=true", "trace=true", "health=true"]
    _cli(tmain, argv)
    root = tmp_path / "o"
    recs = list(tjsonl.read_jsonl(root / "_telemetry.jsonl"))
    assert sorted(r["feature_type"] for r in recs) == ["r21d", "resnet"]
    for rec in recs:
        assert jschema.validate(rec, jschema.load_span_schema()) == []
        assert rec["status"] == "done" and rec["decode_shared_ms"] > 0
        assert [e["mode"] for e in rec["events"]
                if e["kind"] == "source"] == ["shared"]
    hb = json.loads(next(root.glob("_heartbeat_*.json")).read_text())
    assert set(hb["fanout"]["get_starved_ms_total"]) == {"r21d", "resnet"}
    spans = [e for e in json.loads((root / "_trace.json").read_text())
             ["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["args"]["family"] for e in spans
                  if e["name"] == "family") == ["r21d", "resnet"]
    assert any(e["name"] == "fanout.decode_pass" for e in spans)
    for fam in ("resnet/resnet18", "r21d/r2plus1d_18_16_kinetics"):
        assert len(list(tjsonl.read_jsonl(root / fam / "_health.jsonl")))
    _cli(tmain, argv)
    man = json.loads((root / "_run.json").read_text())
    bypass = {s["labels"]["family"]: s["value"]
              for s in man["metrics"]["series"]
              if s["name"] == "vft_cache_bypass_total"}
    assert bypass == {"resnet": 1.0, "r21d": 1.0}
    assert man["tally"]["skipped"] == 2


def test_cache_counters_and_heartbeat_section(tmp_path):
    """``cache=true`` under telemetry: a first run counts a miss, a rerun
    into fresh outputs a hit (its span with no source), and the
    heartbeat's ``cache`` section has JAX's shape and the hit rate; the
    trace holds the lookups, the store and the hit."""
    from video_features_tpu_torch.cli import main as tmain

    def run(out):
        _cli(tmain, ["feature_type=resnet", "model_name=resnet18",
                     "device=cpu", "allow_random_weights=true",
                     "extraction_total=2", "on_extraction=save_numpy",
                     "cache=true", f"cache_dir={tmp_path / 'cache'}",
                     f"output_path={tmp_path / out}",
                     f"tmp_path={tmp_path / 't'}", f"video_paths={SAMPLE}",
                     "telemetry=true", "trace=true"])
        root = tmp_path / out / "resnet" / "resnet18"
        man = json.loads((root / "_run.json").read_text())
        hb = json.loads(next(root.glob("_heartbeat_*.json")).read_text())
        span = _span({"dir": root})
        names = {e["name"] for e in _trace({"dir": root})["traceEvents"]}
        assert "cache.lookup" in names
        assert ("cache.store" in names) is (out == "a")
        assert ("cache.hit" in names) is (out == "b")
        return ({s["name"]: s["value"] for s in man["metrics"]["series"]
                 if s["name"].startswith("vft_cache_")}, hb["cache"], span)

    miss, hb_miss, span_miss = run("a")
    hit, hb_hit, span_hit = run("b")
    assert miss == {"vft_cache_miss_total": 1.0}
    assert hit == {"vft_cache_hit_total": 1.0}
    assert hb_hit == {"hits": {"resnet": 1}, "misses": {}, "bypasses": {},
                      "hit_rate": 1.0}
    assert hb_miss["hit_rate"] == 0.0
    assert [e["kind"] for e in span_miss["events"]][:1] == ["source"]
    assert "source" not in [e["kind"] for e in span_hit["events"]]


def test_fault_counters_equal_jax(tmp_path):
    """The failure journal and the deadline watchdog count into the active
    recorder as JAX's do, and a journal record names the request in
    scope."""
    from video_features_tpu import telemetry as jtel
    from video_features_tpu.telemetry import recorder as jrec
    from video_features_tpu.utils import faults as jfaults
    from video_features_tpu_torch import telemetry as ttel
    from video_features_tpu_torch.telemetry import recorder as trec
    from video_features_tpu_torch.utils import faults as tfaults

    dumps, records = [], []
    for tel, rec_mod, faults, name in ((ttel, trec, tfaults, "port"),
                                       (jtel, jrec, jfaults, "jax")):
        r = rec_mod.TelemetryRecorder(str(tmp_path / name))
        tel._set_active(r)
        try:
            journal = faults.FailureJournal(str(tmp_path / name))
            with tel.use_request("acme-r1"):
                records.append(journal.record("v.mp4", "POISON", 3, "e",
                                              1.0))
            journal.record("w.mp4", "FATAL", 1, "e", 0.5)
            ctx = faults.FaultContext("v.mp4", deadline_s=5.0)
            with contextlib.redirect_stdout(io.StringIO()):
                ctx._expire()
        finally:
            tel._set_active(None)
        dumps.append(r.registry.to_dict())
    assert dumps[0] == dumps[1]
    assert {s["name"] for s in dumps[0]["series"]} == {
        "vft_failures_total", "vft_deadline_expirations_total"}
    assert records[0]["request_id"] == records[1]["request_id"] == "acme-r1"


# -- history and alerts -----------------------------------------------------

def test_jax_readers_agree_with_the_ports_on_its_tree(runs):
    """The port's i3d tree with ``history=true alerts=true``: the JAX
    package's fleet, history and alert readers give what the port's give;
    a sample of the first and of the final heartbeat at least (a run
    slower than the 30 s interval adds a tick's), the last one the final
    heartbeat's; no alert on the clean run; the heartbeat's
    ``alerts`` section and the CLI's exit lines."""
    from video_features_tpu import fleet_report as jfleet
    from video_features_tpu.telemetry import alerts as jalerts
    from video_features_tpu.telemetry import history as jhistory
    from video_features_tpu_torch import fleet_report as tfleet
    from video_features_tpu_torch.telemetry import alerts as talerts
    from video_features_tpu_torch.telemetry import history as thistory

    root = str(runs["port"]["dir"])
    now = 2e9
    assert tfleet.aggregate(root, now=now) == jfleet.aggregate(root,
                                                                now=now)
    assert talerts.observe_root(root, now=now) == \
        jalerts.observe_root(root, now=now)
    series = thistory.read_history(root)
    assert series == jhistory.read_history(root)
    (host, samples), = series.items()
    hb = json.loads(next(runs["port"]["dir"].glob(
        "_heartbeat_*.json")).read_text())
    assert host == hb["host_id"] and len(samples) >= 2
    assert samples[-1] == jhistory.sample_from_heartbeat(
        hb, nonfinite_total=0)
    assert talerts.current_alerts(root) == jalerts.current_alerts(root) \
        == []
    assert hb["alerts"] == {"firing": 0, "pending": 0, "names": [],
                            "eval_errors": 0}
    out = runs["port"]["stdout"]
    assert "heartbeat hooks: 2 registered, 0 failed" in out
    assert "alerts: 0 firing / 0 pending at exit" in out
    assert "scripts/" not in out


@pytest.mark.parametrize("run", ["port", "jax"])
def test_port_report_renders_both_packages_runs(runs, run):
    """``python -m video_features_tpu_torch.telemetry.report`` on each run:
    exit 0 with every gate, the manifest header naming torch and the
    device, the one finished host and the one done span."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "video_features_tpu_torch.telemetry.report",
         str(runs[run]["dir"]), "--fail-on-failures", "--fail-on-slo",
         "--fail-on-alert"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "== heartbeats ==" in out and ": FINISHED" in out
    assert "status: done=1" in out and "== alerts ==" not in out
    if run == "port":
        assert "torch=" in out and "device=None" in out


@pytest.mark.parametrize("key,value,telemetry", [
    ("history", "yes", True), ("alerts", 1, True), ("history", True, False),
    ("alerts", True, False)])
def test_history_and_alerts_config_errors_equal_jax(tmp_path, key, value,
                                                    telemetry):
    """Neither key is gated; a bad value, or either key without
    ``telemetry=true``, raises JAX's error (its message up to the pointer
    at the package's own docs or tools)."""
    from video_features_tpu import config as jconfig
    from video_features_tpu_torch import config as tconfig

    assert key not in tconfig.GATED_KEYS
    errors = []
    for mod in (tconfig, jconfig):
        cfg = mod.load_config("resnet", {
            key: value, "telemetry": telemetry, "device": "cpu",
            "output_path": str(tmp_path / "o"),
            "tmp_path": str(tmp_path / "t"), "video_paths": "a.mp4"})
        with pytest.raises(ValueError) as e:
            mod.sanity_check(cfg)
        errors.append(str(e.value).split(" (")[0])
    assert errors[0] == errors[1]
    ok = tconfig.load_config("resnet", {
        key: True, "telemetry": True, "device": "cpu",
        "output_path": str(tmp_path / "o"), "tmp_path": str(tmp_path / "t"),
        "video_paths": "a.mp4"})
    tconfig.sanity_check(ok)


def test_injected_fault_fires_bundles_and_resolves(tmp_path):
    """JAX's acceptance loop on the port's CLI: resnet18 with an injected
    ENOSPC at the first ``sink.fsync`` and one attempt fires exactly one
    ``failure_spike`` with a valid record and a bundle that holds the
    failure journal and the heartbeats and that both packages' verifiers
    accept; the retained history carries the failure; a later one-shot
    evaluation over a shrunken window resolves it, and then no package's
    reader sees an alert; the record keeps pointing at the bundle."""
    import time

    from video_features_tpu.telemetry import alerts as jalerts
    from video_features_tpu.telemetry import history as jhistory
    from video_features_tpu_torch.cli import main as tmain
    from video_features_tpu_torch.telemetry import alerts as talerts
    from video_features_tpu_torch.telemetry import history as thistory

    out = _cli(tmain, [
        "feature_type=resnet", "model_name=resnet18", "device=cpu",
        "allow_random_weights=true", "extraction_total=4",
        "on_extraction=save_numpy", f"output_path={tmp_path / 'o'}",
        f"tmp_path={tmp_path / 't'}", f"video_paths={SAMPLE}",
        "telemetry=true", "alerts=true", "history=true",
        "metrics_interval_s=0.3", "retry_attempts=1",
        "inject=seed=0;sink.fsync=enospc@n1"])
    assert "1 failed" in out and "alerts: 1 firing / 0 pending" in out
    root = tmp_path / "o" / "resnet" / "resnet18"
    recs = list(tjsonl.read_jsonl(root / "_alerts.jsonl"))
    assert recs and all(talerts.validate_alert(r) == [] ==
                        jalerts.validate_alert(r) for r in recs)
    firing = [r for r in recs if r["state"] == "firing"]
    assert [r["rule"] for r in firing] == ["failure_spike"]
    assert firing[0]["run_id"] is not None
    bundle = root / firing[0]["incident"]
    assert talerts.verify_incident(bundle) == [] == \
        jalerts.verify_incident(bundle)
    paths = [a["path"] for a in json.loads(
        (bundle / "manifest.json").read_text())["artifacts"]]
    assert any("_failures" in p for p in paths)
    assert any(p.startswith("heartbeats/") for p in paths)
    series = thistory.read_history(str(root))
    assert series == jhistory.read_history(str(root))
    (host, samples), = series.items()
    assert samples[-1]["videos"]["error"] == 1
    assert talerts.current_alerts(root) == jalerts.current_alerts(root)
    time.sleep(0.3)
    with contextlib.redirect_stdout(io.StringIO()):
        assert talerts.main([str(root), "--window", "0.05"]) == 0
    final = {(r["rule"], r["scope"]): r
             for r in tjsonl.read_jsonl(root / "_alerts.jsonl")}
    assert final[("failure_spike", host)]["state"] == "resolved"
    assert final[("failure_spike", host)]["incident"] == \
        firing[0]["incident"]
    assert talerts.current_alerts(root) == [] == \
        jalerts.current_alerts(root)
