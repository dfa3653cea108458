"""The port's roofline and parity observatories against the JAX package's.

One module fixture runs each package's CLI in process on the vendored
sample video, both reading one set of seeded weights (checkpoints in the
reference's layout written by the port's seeded init and read by both
through their weights paths): i3d with ``flow_type=raft`` (``flow_iters=2``,
10-frame stacks, ``extraction_fps=1``: one stack) with ``roofline=true
parity=true telemetry=true`` in both packages and once in the port with
every one of these keys off, and the raft family (``side_size=64``,
``iters=2``, 9 frames, 4 pairs a batch) with ``parity=true`` in both. Both
packages read the peak from ``VFT_ROOFLINE_PEAK``.

Held, with the tolerances stated where there are any:
  - the field tuples, verdicts, seams, tolerance bands with their ``why``,
    thresholds and bounds equal JAX's, and the port's schema files are the
    JAX files but for their description; ``classify`` equals JAX's on a
    grid of inputs; the registry keeps JAX's TPU rows and names the H100
    SXM alone;
  - the port's ``_roofline.json``, ``_parity.jsonl`` records and certify
    verdict validate under the JAX package's schemas;
  - ``digest_seam`` equals JAX's on the same arrays (all but ``time``);
    ``compare_captures`` gives JAX's table, first seam and verdict;
  - JAX and the port emit the same (seam, key, index) records (i3d taps
    no backbone seam in either package, raft all four); the decode-seam
    digests are equal;
  - the port's FLOP count of a small I3D RGB, R(2+1)D-18 and ResNet-18
    is within 2% of JAX's ``program_cost`` (measured 1.000001x,
    1.000001x and 1.000000x: both count a convolution's taps on the data
    only and one FLOP an element of a pointwise op), and its bytes are in
    a band of their own for each (0.8877x, 0.7793x, 0.8630x), the gap
    held op class by op class against each instruction of JAX's lowered
    program (:data:`BYTES_GAP_MB`: JAX's unfused program writes its
    broadcasts out at full size and its elementwise ops read them back,
    while the port's I3D pads apart and its max pools write indices);
  - XLA's rule on one-op nets, against JAX's own count of the same ops: a
    padded convolution counts its taps on the data, an ``F.pad`` before a
    VALID convolution counts as the padded one, a ReLU one FLOP an
    element, a variance as ``jnp.var``, and an op that returns its own
    input no bytes;
  - a small RAFT's card: its dense ops within 2% of JAX's gather RAFT's
    count less JAX's own lookups, the same for every lookup path, plus
    each lookup's declared work (``kernel_work``) and none of the plain
    lookups' own ops;
  - the port's own behaviour, after JAX's ``tests/test_parity.py`` and
    ``tests/test_roofline.py``: the off path writes nothing and its
    features are byte-identical, certify's identity A/B is bit-exact and a
    perturbed seam fails there first, distinct shapes get distinct cards,
    the peak's env, registry and cache precedence, the heartbeat and
    manifest sections, the report.
"""
import contextlib
import io
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from video_features_tpu.telemetry import parity as jparity
from video_features_tpu.telemetry import roofline as jroofline
from video_features_tpu.utils import profiling as jprofiling
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.telemetry import jsonl as tjsonl
from video_features_tpu_torch.telemetry import parity as tparity
from video_features_tpu_torch.telemetry import roofline as troofline

REPO = Path(__file__).resolve().parents[1]
SAMPLE = REPO / "tests" / "assets" / "v_synth_sample.mp4"
ON = ["roofline=true", "parity=true", "telemetry=true"]
PEAK = "100,1000"
#: the port's FLOPs over JAX's program_cost, at most 2% either way
#: (module docstring)
FLOP_RATIO = (0.98, 1.02)
#: the port's bytes over JAX's, a band about each model's measured ratio:
#: JAX's unfused broadcasts on one side, the port's separate pads and
#: pool indices on the other (``telemetry/roofline.py``'s docstring)
BYTES_RATIO = {"i3d_rgb": (0.885, 0.890), "r21d": (0.777, 0.782),
               "resnet18": (0.860, 0.866)}
#: the port's bytes less JAX's, in MB, for each op class that differs
#: (``telemetry/roofline.py``'s docstring); each within 1% of its value,
#: and every other class within 0.5 MB of JAX's
BYTES_GAP_MB = {
    "i3d_rgb": {"broadcast": -172.49, "elementwise": -171.06,
                "zero-width pad": 121.23, "zero pad": 43.09,
                "pool": 43.87, "convolution": 10.54},
    "r21d": {"broadcast": -31.21, "elementwise": -30.83},
    "resnet18": {"broadcast": -4.87, "elementwise": -4.73, "pool": 0.26}}
#: op classes: the port's aten ops and JAX's HLO opcodes that do one job;
#: an op of no class is its own
OP_CLASSES = {
    "convolution": ({"aten.convolution"}, {"convolution"}),
    "zero pad": ({"aten.constant_pad_nd"}, {"pad"}),
    "zero-width pad": ({"aten.constant_pad_nd (zero width)"}, set()),
    "pool": ({"aten.max_pool2d_with_indices", "aten.max_pool3d_with_indices",
              "aten.avg_pool2d", "aten.avg_pool3d"}, {"reduce-window"}),
    "broadcast": (set(), {"broadcast"}),
    "elementwise": ({"aten.mul", "aten.add", "aten.relu"},
                    {"multiply", "add", "maximum"}),
    "layout": ({"aten.view", "aten.permute", "aten.slice", "aten.select",
                "aten._unsafe_view", "aten.expand", "aten.t"},
               {"reshape", "transpose", "slice", "bitcast"}),
    "concatenate": ({"aten.cat"}, {"concatenate"}),
    "convert": ({"aten._to_copy"}, {"convert"}),
    "subtract": ({"aten.sub"}, {"subtract"}),
    "rsqrt": ({"aten.rsqrt"}, {"rsqrt"}),
    "divide": ({"aten.div"}, {"divide"}),
    "reduce": ({"aten.mean", "aten.sum"}, {"reduce"}),
    "fill": ({"aten.zeros_like", "aten.zeros", "aten.fill"}, set()),
}


def _cli(main, argv):
    """``main(argv)`` in process; its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output dir and stdout of each run: ``jax``, ``port`` and ``port_off``
    (i3d RAFT), ``jax_raft`` and ``port_raft`` (the raft family)."""
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain
    from video_features_tpu_torch.extractors.i3d_flow import SEED_RAFT
    from video_features_tpu_torch.models import i3d as ti3d
    from video_features_tpu_torch.models import raft as traft
    from video_features_tpu_torch.weights.bridge import seeded_init_

    tmp = tmp_path_factory.mktemp("roofline_parity")
    ckpt = {"weights_path": (ti3d.I3D(400, in_channels=3), 31),
            "flow_weights_path": (ti3d.I3D(400, in_channels=2), 32),
            "flow_model_weights_path": (traft.RAFT(2), 33),
            "raft": (traft.RAFT(2), SEED_RAFT)}
    paths = {}
    for key, (net, seed) in ckpt.items():
        paths[key] = tmp / f"{key}.pt"
        torch.save(seeded_init_(net, seed).state_dict(), paths[key])
    i3d = ["feature_type=i3d", "device=cpu", "flow_type=raft",
           "flow_iters=2", "stack_size=10", "step_size=10",
           "extraction_fps=1", "on_extraction=save_numpy",
           f"video_paths={SAMPLE}"] + [
        f"{k}={paths[k]}" for k in ("weights_path", "flow_weights_path",
                                    "flow_model_weights_path")]
    raft = ["feature_type=raft", "device=cpu", "side_size=64", "iters=2",
            "extraction_total=9", "batch_size=4", "on_extraction=save_numpy",
            f"weights_path={paths['raft']}", f"video_paths={SAMPLE}"]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        mp.setenv("VFT_ROOFLINE_PEAK", PEAK)
        for name, main, argv, fam in (
                ("jax", jmain, i3d + ON, "i3d"),
                ("port", tmain, i3d + ON + [
                    f"profile_trace_dir={tmp / 'prof'}"], "i3d"),
                ("port_off", tmain, i3d, "i3d"),
                ("jax_raft", jmain, raft + ["parity=true"], "raft"),
                ("port_raft", tmain, raft + ["parity=true"], "raft")):
            root = tmp / name
            stdout = _cli(main, argv + [f"output_path={root / 'o'}",
                                        f"tmp_path={root / 't'}"])
            out[name] = dict(dir=root / "o" / fam, stdout=stdout)
        out["port"]["prof"] = tmp / "prof"
        yield out
    finally:
        mp.undo()
        jprofiling.profiler.enabled = False
        jprofiling.profiler.reset()
        for p in paths.values():
            p.unlink(missing_ok=True)


def _parity(run) -> list:
    return list(tjsonl.read_jsonl(run["dir"] / "_parity.jsonl"))


def _roofline(run) -> dict:
    return json.loads((run["dir"] / "_roofline.json").read_text())


# -- the contracts ----------------------------------------------------------

@pytest.mark.parametrize("name", [
    "ROOFLINE_FIELDS", "DEVICE_FIELDS", "FAMILY_FIELDS", "CARD_FIELDS",
    "VERDICTS", "HOST_BOUND_SHARE", "LAUNCH_FRAC", "SCHEMA_VERSION",
    "ROOFLINE_FILENAME"])
def test_roofline_contract_equals_jax(name):
    assert getattr(troofline, name) == getattr(jroofline, name)


@pytest.mark.parametrize("name", [
    "SEAMS", "VERDICTS", "PARITY_FIELDS", "VERDICT_FIELDS", "TOLERANCES",
    "MAX_PER_KEY", "CERTIFY_PER_KEY", "SCHEMA_VERSION", "VERDICT_SCHEMA",
    "PARITY_FILENAME", "VERDICT_FILENAME"])
def test_parity_contract_equals_jax(name):
    """``TOLERANCES`` whole: every band and its written ``why``."""
    assert getattr(tparity, name) == getattr(jparity, name)
    assert tparity.validate_tolerances() == []


@pytest.mark.parametrize("name,fields", [
    ("roofline.schema.json", troofline.ROOFLINE_FIELDS),
    ("parity.schema.json", tparity.PARITY_FIELDS),
    ("parity_verdict.schema.json", tparity.VERDICT_FIELDS)])
def test_schema_files_are_jax_files(name, fields):
    port = json.loads((REPO / "video_features_tpu_torch" / "telemetry" /
                       name).read_text())
    jax = json.loads((REPO / "video_features_tpu" / "telemetry" /
                      name).read_text())
    port.pop("description")
    jax.pop("description")
    assert port == jax
    assert tuple(port["properties"]) == fields
    if name == "roofline.schema.json":
        fam = port["properties"]["families"]["additionalProperties"]
        assert tuple(port["properties"]["device"]["properties"]) == \
            troofline.DEVICE_FIELDS
        assert tuple(fam["properties"]) == troofline.FAMILY_FIELDS
        assert tuple(fam["properties"]["programs"]["items"][
            "properties"]) == troofline.CARD_FIELDS
        assert tuple(v for v in fam["properties"]["verdict"]["enum"]
                     if v) == troofline.VERDICTS


def test_classify_equals_jax_on_a_grid():
    seen = set()
    for flops in (0.0, 1e9, 1e12, 5e13):
        for nbytes in (0.0, 1e8, 1e11):
            for fwd in (None, 0.0, 0.01, 0.5, 2.0):
                for wall in (0.0, 1.0, 4.0):
                    for peak_tf, peak_gb in ((None, None), (100.0, None),
                                             (100.0, 1000.0)):
                        args = (flops, nbytes, fwd, wall, peak_tf, peak_gb)
                        got = troofline.classify(*args)
                        assert got == jroofline.classify(*args), args
                        seen.add(got)
    assert seen == set(troofline.VERDICTS) | {None}


def test_registry_keeps_jax_rows_and_names_the_h100_sxm_alone():
    for kind, entry in jroofline.PEAK_REGISTRY.items():
        assert troofline.PEAK_REGISTRY[kind] == entry
    h100 = troofline.registry_peak("NVIDIA H100 80GB HBM3")
    assert h100["nominal_tflops"] == 989.4 and h100["peak_gbps"] == 3350.0
    assert 0 < h100["peak_tflops"] <= h100["nominal_tflops"]
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-"
                  "80GB", "cpu"):
        assert troofline.registry_peak(other) is None, other


@pytest.mark.parametrize("value", [
    np.linspace(-3, 3, 60, dtype=np.float32).reshape(3, 4, 5),
    np.arange(24, dtype=np.uint8).reshape(2, 4, 3),
    np.array([1.0, np.nan, np.inf, -2.0])], ids=["f32", "u8", "nonfinite"])
def test_digest_seam_equals_jax(value):
    kw = dict(video="v.mp4", feature_type="i3d", index=3)
    got = tparity.digest_seam("backbone", "rgb", value, **kw)
    want = jparity.digest_seam("backbone", "rgb", value, **kw)
    got.pop("time")
    want.pop("time")
    assert got == want
    assert tuple(got) == tuple(f for f in tparity.PARITY_FIELDS
                               if f != "time")


def _captures(seed: int):
    rng = np.random.default_rng(seed)
    caps = {}
    for seam in tparity.SEAMS:
        for i in range(2):
            caps[("v.mp4", seam, "k", i)] = rng.normal(size=(3, 5))
    return caps


@pytest.mark.parametrize("case", ["identical", "transform", "backbone",
                                  "shape", "missing"])
def test_compare_captures_equals_jax(case):
    ref = _captures(0)
    cand = {k: v.copy() for k, v in ref.items()}
    if case in ("transform", "backbone"):
        for k in cand:
            if k[1] == case:
                cand[k] = cand[k] + (1.0 if case == "transform" else 3.0)
    elif case == "shape":
        cand[("v.mp4", "head", "k", 1)] = np.zeros((2, 5))
    elif case == "missing":
        del cand[("v.mp4", "decode", "k", 0)]
    got = tparity.compare_captures(ref, cand, "raft")
    assert got == jparity.compare_captures(ref, cand, "raft")
    first = {"identical": None, "transform": "transform",
             "backbone": "backbone", "shape": "head",
             "missing": "decode"}[case]
    assert got[1] == first and got[2] == ("PASS" if first is None
                                          else "FAIL")


# -- the CLI runs -----------------------------------------------------------

def test_port_artifacts_validate_under_jax_schemas(runs, tmp_path):
    from video_features_tpu.telemetry import schema as jschema
    doc = _roofline(runs["port"])
    assert jschema.validate(doc, jroofline.load_roofline_schema()) == []
    assert jroofline.validate_roofline(doc) == []
    recs = _parity(runs["port"]) + _parity(runs["port_raft"])
    assert recs and all(jparity.validate_parity(r) == [] for r in recs)
    verdict = tparity.certify("raft", flip="dtype=bf16", frames=3,
                              out_dir=str(tmp_path),
                              extra_overrides=_SMALL_RAFT)
    assert jparity.validate_verdict(verdict) == []
    on_disk = json.loads((tmp_path / tparity.VERDICT_FILENAME).read_text())
    assert on_disk == verdict


@pytest.mark.parametrize("family", ["i3d", "raft"])
def test_records_equal_jax_and_decode_digests(runs, family):
    """The same (seam, key, index) records: i3d taps no backbone seam in
    either package, raft taps all four; the decode-seam digests equal
    JAX's (same cv2 frames) but for the time."""
    suffix = "" if family == "i3d" else "_raft"
    port, jax = _parity(runs["port" + suffix]), _parity(runs["jax" + suffix])
    keys = {(r["seam"], r["key"], r["index"]) for r in port}
    want = {(r["seam"], r["key"], r["index"]) for r in jax}
    assert keys == want
    assert {s for s, _, _ in keys} == (set(tparity.SEAMS) - {"backbone"}
                                       if family == "i3d"
                                       else set(tparity.SEAMS))
    by_key = {(r["seam"], r["key"], r["index"]): r for r in jax}
    decode = [r for r in port if r["seam"] == "decode"]
    assert len(decode) == tparity.MAX_PER_KEY
    for r in decode:
        j = dict(by_key[(r["seam"], r["key"], r["index"])])
        got = dict(r)
        assert got.pop("time") and j.pop("time")
        assert got == j


def test_off_path_zero_footprint_and_byte_identity(runs):
    """``roofline`` and ``parity`` off: no artifact, and the on run's
    features are the off run's byte for byte."""
    on, off = runs["port"]["dir"], runs["port_off"]["dir"]
    assert not {"_parity.jsonl", "_roofline.json"} & {
        p.name for p in off.iterdir()}
    for key in ("rgb", "flow", "fps", "timestamps_ms"):
        a = (on / f"{SAMPLE.stem}_{key}.npy").read_bytes()
        assert a == (off / f"{SAMPLE.stem}_{key}.npy").read_bytes(), key
    assert "roofline:" in runs["port"]["stdout"]
    assert "roofline:" not in runs["port_off"]["stdout"]


def test_roofline_document_counts_the_run(runs):
    """One i3d card, counted on the CPU: FLOPs over both I3Ds and RAFT,
    the peak from the env, the time on the CPU's clock."""
    doc = _roofline(runs["port"])
    jdoc = _roofline(runs["jax"])
    assert doc["device"]["source"] == jdoc["device"]["source"] == "env"
    assert doc["device"]["device_kind"] == "cpu"
    fam = doc["families"]["i3d"]
    assert fam["dispatches"] == 1 == len(fam["programs"])
    assert fam["programs"][0]["dtype"] == "uint8"
    assert fam["forward_s"] > 0 and fam["forward_calls"] == 1
    assert fam["mfu"] == pytest.approx(fam["effective_tflops"] / 100.0,
                                       abs=1e-4)
    assert fam["verdict"] in troofline.VERDICTS
    assert set(fam) == set(jdoc["families"]["i3d"])


def test_heartbeat_and_manifest_sections(runs):
    d = runs["port"]["dir"]
    beat = json.loads(next(d.glob("_heartbeat_*.json")).read_text())
    man = json.loads((d / "_run.json").read_text())
    assert beat["final"]
    assert beat["parity"]["records"] == len(_parity(runs["port"]))
    assert set(beat["parity"]["seams"]) == set(tparity.SEAMS) - {
        "backbone"}
    fam = beat["roofline"]["families"]["i3d"]
    assert set(fam) == {"dispatches", "effective_tflops", "mfu",
                        "device_share", "verdict", "gflops_total"}
    assert man["roofline"]["schema"] == troofline.SCHEMA_VERSION
    assert troofline.validate_roofline(man["roofline"]) == []
    jbeat = json.loads(next(runs["jax"]["dir"].glob(
        "_heartbeat_*.json")).read_text())
    assert set(beat["roofline"]) == set(jbeat["roofline"])
    assert set(beat["parity"]) == set(jbeat["parity"])


def test_reports_render_the_run(runs, capsys):
    d = runs["port"]["dir"]
    assert troofline.report_main([str(d), "--profile",
                                  str(runs["port"]["prof"])]) == 0
    out = capsys.readouterr().out
    assert "== roofline (per-family MFU) ==" in out and "i3d" in out
    assert "== per-op breakdown" in out
    assert tparity.main([str(d), "--validate"]) == 0
    out = capsys.readouterr().out
    assert all(seam in out for seam in ("decode", "transform", "head"))


# -- the FLOP count ---------------------------------------------------------

def _jax_program(model: str, shape):
    """JAX's jitted forward of ``model`` and its arguments' shapes."""
    import jax
    import jax.numpy as jnp

    from video_features_tpu.models import i3d as ji3d
    from video_features_tpu.models import r21d as jr21d
    from video_features_tpu.models import resnet as jresnet
    if model == "i3d_rgb":
        m = ji3d.I3D(num_classes=400)
        params = jax.eval_shape(lambda: ji3d.init_params("rgb"))
        fn = jax.jit(lambda p, v: m.apply({"params": p}, v, features=True))
    elif model == "r21d":
        params = jax.eval_shape(lambda: jr21d.init_params()["backbone"])
        fn = jax.jit(lambda p, v: jr21d.R2Plus1D().apply({"params": p}, v))
    else:
        m = jresnet.ResNet(model)
        params = jax.eval_shape(lambda: m.init(
            jax.random.PRNGKey(0), jnp.zeros(shape))["params"])
        fn = jax.jit(lambda p, v: m.apply({"params": p}, v))
    return fn, (params, jax.ShapeDtypeStruct(shape, jnp.float32))


_HLO_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s64": 8,
              "pred": 1, "u8": 1, "s8": 1, "f64": 8}
_HLO_SHAPE = re.compile(r"\b(f32|bf16|f16|s32|u32|s64|pred|u8|s8|f64)"
                        r"\[([0-9,]*)\]")
_HLO_INSTR = re.compile(r"\s*(?:ROOT\s+)?([\w.\-]+)\s*=\s*(\S+)\s+"
                        r"([\w\-]+)\((.*?)\)(.*)$")
_HLO_HEAD = re.compile(r"^(ENTRY\s+)?([\w.\-]+)\s.*\{$")


def _hlo_nbytes(text: str) -> int:
    return sum(_HLO_BYTES[dtype] * int(np.prod(
        [int(d) for d in dims.split(",") if d], dtype=np.int64))
        for dtype, dims in _HLO_SHAPE.findall(text))


def _hlo_bytes_by_op(hlo: str) -> dict:
    """``{opcode: bytes}`` of an HLO module's entry computation, calls
    expanded into their callees: each instruction's operands and result,
    as XLA's cost analysis counts the unfused program's bytes."""
    comps, entry, cur = {}, None, None
    for line in hlo.splitlines():
        head = _HLO_HEAD.match(line)
        if head and not line.startswith(" "):
            cur = head.group(2)
            comps[cur] = []
            entry = cur if head.group(1) else entry
            continue
        m = _HLO_INSTR.match(line)
        if m and cur:
            comps[cur].append(m.groups())
    out: dict = {}

    def walk(comp):
        sizes = {}
        for name, result, op, operands, tail in comps[comp]:
            sizes[name] = _hlo_nbytes(result)
            if op in ("parameter", "constant", "tuple", "get-tuple-element"):
                continue
            if op == "call":
                walk(re.search(r"to_apply=([\w.\-]+)", tail).group(1))
                continue
            args = [a.strip() for a in operands.split(",") if a.strip()]
            out[op] = out.get(op, 0) + sizes[name] + sum(
                sizes.get(a, 0) for a in args)

    walk(entry)
    return out


def _by_class(op_bytes: dict, side: int) -> dict:
    """``{op class: bytes}`` of ``{op: bytes}``; ``side`` 0 is the port's
    aten ops, 1 JAX's HLO opcodes."""
    out: dict = {}
    for op, nbytes in op_bytes.items():
        name = next((k for k, v in OP_CLASSES.items() if op in v[side]), op)
        out[name] = out.get(name, 0) + nbytes
    return out


@pytest.mark.parametrize("model,shape", [
    ("i3d_rgb", (1, 10, 224, 224, 3)), ("r21d", (1, 8, 32, 32, 3)),
    ("resnet18", (2, 64, 64, 3))])
def test_flop_count_near_jax_program_cost(model, shape):
    from video_features_tpu_torch.models import i3d as ti3d
    from video_features_tpu_torch.models import r21d as tr21d
    from video_features_tpu_torch.models import resnet as tresnet
    if model == "i3d_rgb":
        net = ti3d.I3D(400, in_channels=3).eval()
        fn = lambda v: net(v, features=True)  # noqa: E731
    elif model == "r21d":
        fn = tr21d.R2Plus1D().eval()
    else:
        fn = tresnet.ResNet(model).eval()
    x = torch.zeros(shape)
    with torch.inference_mode(), troofline.CostCounter() as got:
        fn(x)
    jfn, args = _jax_program(model, shape)
    want = jroofline.program_cost(jfn, *args)
    assert FLOP_RATIO[0] <= got.flops / want["flops"] <= FLOP_RATIO[1]
    lo, hi = BYTES_RATIO[model]
    assert lo <= got.bytes / want["bytes"] <= hi
    # the bytes gap, op class by op class: JAX's side is each instruction
    # of its lowered program, which sums to XLA's count
    jax_ops = _hlo_bytes_by_op(jfn.lower(*args).as_text(dialect="hlo"))
    assert sum(jax_ops.values()) == pytest.approx(want["bytes"], rel=1e-5)
    port = _by_class({k: v[2] for k, v in got.by_op.items()}, 0)
    jax_ = _by_class(jax_ops, 1)
    gap = {k: (port.get(k, 0) - jax_.get(k, 0)) / 1e6
           for k in set(port) | set(jax_)}
    named = BYTES_GAP_MB[model]
    assert {k: gap[k] for k in named} == pytest.approx(named, rel=0.01)
    assert all(abs(v) < 0.5 for k, v in gap.items() if k not in named), gap


def _jax_one_op_cost(fn, *shapes):
    import jax
    import jax.numpy as jnp
    return jroofline.program_cost(jax.jit(fn), *(
        jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes))


#: the small RAFT of the card tests: iterations, batch, height, width
_RAFT_CARD = (2, 2, 64, 96)


@pytest.fixture(scope="module")
def raft_card():
    """The small RAFT's input, the declared cells of its lookups, and JAX's
    count of its gather RAFT's dense ops: XLA's cost analysis counts a
    while loop's body once (JAX's ``nn.scan`` over the update iterations;
    the same count at any ``iters``), so the dense count is the RAFT's
    plus ``iters - 1`` update iterations lowered alone, less ``iters``
    gather lookups lowered alone."""
    import jax
    import jax.numpy as jnp

    from video_features_tpu.models import raft as jraft
    iters, b, h, w = _RAFT_CARD
    h8, w8 = h // 8, w // 8
    f32 = jnp.float32

    def spec(*shape):
        return jax.ShapeDtypeStruct(shape, f32)

    def cost(module, *args):
        params = jax.eval_shape(lambda *a: module.init(
            jax.random.PRNGKey(0), *a)["params"], *args)
        return jroofline.program_cost(jax.jit(
            lambda p, *a: module.apply({"params": p}, *a)), params,
            *args)["flops"]

    prev = dict(jraft._CORR_CONFIG)
    jraft.configure_corr_lookup(impl="gather")
    try:
        pyramid = tuple(spec(b, h8 * w8, h8 >> lvl, w8 >> lvl)
                        for lvl in range(tcl.LEVELS))
        raft = cost(jraft.RAFT(iters=iters), spec(b, h, w, 3),
                    spec(b, h, w, 3))
        update = cost(jraft.UpdateIter(),
                      (spec(b, h8, w8, 128), spec(b, h8, w8, 2)),
                      (pyramid, spec(b, h8, w8, 128), spec(b, h8, w8, 2)))
        lookup = jroofline.program_cost(
            jax.jit(jraft.corr_lookup_gather), pyramid,
            spec(b, h8, w8, 2))["flops"]
    finally:
        jraft._CORR_CONFIG.update(prev)
    q = b * h8 * w8
    shapes = [(h8 >> lvl, w8 >> lvl) for lvl in range(tcl.LEVELS)]
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (b, h, w, 3)).astype(np.float32))
    return {"x": x, "q": q, "cells": tcl.declared_cells(shapes, q),
            "jax_dense": raft + (iters - 1) * update - iters * lookup}


@pytest.mark.parametrize("impl,kernel", [(None, "proj"), ("gather", "level"),
                                         ("packed", "packed")])
def test_small_raft_card_is_dense_plus_declared_work(impl, kernel,
                                                     raft_card):
    """``program_cost`` of a small RAFT: its dense ops, counted as JAX's
    gather RAFT counts its own (less JAX's lookups), plus each
    iteration's lookup as ``kernel``'s declared work; the fused path's
    proj also takes over convc1, whose 1x1 convolution counts 2 x its
    taps, its bias add and its ReLU one FLOP an element each. Every path
    leaves the same dense count, so no plain lookup's own ops are
    counted, and a plain lookup alone counts its declared work only."""
    from video_features_tpu_torch.models import raft as traft
    from video_features_tpu_torch.weights.bridge import seeded_init_
    iters = _RAFT_CARD[0]
    x, q, cells = raft_card["x"], raft_card["q"], raft_card["cells"]
    net = seeded_init_(traft.RAFT(iters, impl), 5).eval()
    gather_net = seeded_init_(traft.RAFT(iters, "gather"), 5).eval()
    with torch.inference_mode():
        got = troofline.program_cost(net, x, x)
        gather = troofline.program_cost(gather_net, x, x)
    nbytes, ops = tcl.kernel_work(kernel, q, cells)
    _, level_ops = tcl.kernel_work("level", q, cells)
    convc1 = 2 * q * tcl.LEVELS * tcl.TAPS * 256 + 2 * q * 256
    dense = got["flops"] - iters * ops + (
        iters * convc1 if kernel == "proj" else 0)
    assert dense == gather["flops"] - iters * level_ops
    want = raft_card["jax_dense"]
    assert FLOP_RATIO[0] <= dense / want <= FLOP_RATIO[1]
    assert got["bytes"] > iters * nbytes
    # the plain gather lookup alone: its declared work, none of its ops
    fmap = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 64, 8, 12)).astype(np.float32))
    pyramid = traft.build_corr_pyramid(fmap, fmap)
    coords = torch.zeros(1, 8, 12, 2)
    shapes = [tuple(level.shape[2:]) for level in pyramid]
    lookup = troofline.program_cost(tcl.corr_lookup_gather_ref, pyramid,
                                    coords)
    assert lookup["flops"] == tcl.kernel_work(
        "level", 96, tcl.declared_cells(shapes, 96))[1]


def test_cost_counter_counts_as_flop_counter_mode():
    """The XLA rule on the same net (the name is that of the count it
    replaced): the padded 3x3 convolution counts its taps on the data
    (46 of 48 a row and a column) and its bias, the ReLU and the linear's
    bias one FLOP an element, the linear 2 M N K; equal to JAX's count of
    the same ops."""
    import jax
    import jax.numpy as jnp
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                              torch.nn.ReLU(), torch.nn.Linear(16, 4))
    x = torch.ones(2, 3, 16, 16)
    with torch.inference_mode():
        with troofline.CostCounter() as c:
            out = net(x)
    conv = 2 * 2 * 8 * 3 * 46 * 46 + 2 * 8 * 16 * 16
    relu = 2 * 8 * 16 * 16
    linear = 2 * (2 * 8 * 16) * 16 * 4 + 2 * 8 * 16 * 4
    assert c.flops == conv + relu + linear

    def jax_net(v, wc, bc, wl, bl):
        y = jax.lax.conv_general_dilated(
            v, wc, (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        y = jnp.maximum(y + bc[None, :, None, None], 0.0)
        return y @ wl + bl
    want = _jax_one_op_cost(jax_net, (2, 3, 16, 16), (8, 3, 3, 3), (8,),
                            (16, 4), (4,))
    assert c.flops == want["flops"]
    # every op's inputs and outputs: the conv, relu and linear at least
    assert c.bytes >= 2 * x.numel() * 4 + out.numel() * 4


@pytest.mark.parametrize("pads,kernel", [
    ((1, 1, 1, 1), (3, 3)), ((0, 1, 0, 1), (2, 2)), ((3, 3, 3, 3), (7, 7)),
    ((1, 1, 1, 1, 1, 1), (3, 3, 3)), ((0, 0, 0, 0, 0, 0), (1, 1, 1))])
def test_zero_pad_then_valid_convolution_counts_as_padded(pads, kernel):
    """``F.pad`` with zeros, then a VALID convolution (the port's I3D, the
    TF SAME rule), counts what the convolution padded by itself counts and
    what JAX counts for it: the padded zeros are no taps on the data. The
    pad's own traffic is counted."""
    import torch.nn.functional as F
    conv = torch.nn.functional.conv2d if len(kernel) == 2 else \
        torch.nn.functional.conv3d
    spatial = (9,) * len(kernel)
    x = torch.ones(1, 2, *spatial)
    w = torch.ones(3, 2, *kernel)
    padding = [(pads[2 * i], pads[2 * i + 1]) for i in range(len(kernel))]
    with torch.inference_mode():
        with troofline.CostCounter() as explicit:
            conv(F.pad(x, pads), w)
        with troofline.CostCounter() as whole:
            conv(x, w)
    dims = "".join("DHW"[3 - len(kernel):])
    want = _jax_one_op_cost(
        lambda v, k: __import__("jax").lax.conv_general_dilated(
            v, k, (1,) * len(kernel), padding[::-1],
            dimension_numbers=(f"NC{dims}", f"OI{dims}", f"NC{dims}")),
        x.shape, w.shape)["flops"]
    assert explicit.flops == want
    if not any(pads):
        assert explicit.flops == whole.flops
    else:
        assert explicit.flops < 2 * 3 * 2 * int(np.prod(
            [s + a + b - k + 1 for s, k, (a, b) in zip(
                spatial, kernel, padding)])) * int(np.prod(kernel))
    assert explicit.bytes > whole.bytes


def test_instance_norm_counts_as_jax_instance_norm():
    """RAFT's feature encoder normalizes with the batch's statistics: 7
    FLOPs an element, as JAX's ``instance_norm`` lowers (its per-channel
    statistics' few ops apart, within 0.1%), whether through the batch
    norm op or through the port's RAFT ``instance_norm``, which takes a
    mean and a variance."""
    from video_features_tpu.models.raft import instance_norm
    from video_features_tpu_torch.models import raft as traft
    x = torch.ones(2, 32, 16, 24)
    with torch.inference_mode():
        with troofline.CostCounter() as c:
            torch.nn.functional.instance_norm(x)
        with troofline.CostCounter() as port:
            traft.instance_norm(x)
    want = _jax_one_op_cost(instance_norm, (2, 16, 24, 32))["flops"]
    assert c.flops == 7 * x.numel()
    assert abs(c.flops / want - 1) < 1e-3
    assert abs(port.flops / want - 1) < 1e-3


@pytest.mark.parametrize("shape,dims", [((2, 16, 24, 32), (1, 2)),
                                        ((5, 7), (1,)), ((5, 7), (0,)),
                                        ((3, 4, 6), None)])
def test_variance_counts_as_jnp_var(shape, dims):
    """4 FLOPs an element, 1 a result and 3 for the ddof, as ``jnp.var``
    lowers; ``std`` the same (its square root counts 0)."""
    import jax.numpy as jnp
    x = torch.ones(shape)
    with torch.inference_mode():
        with troofline.CostCounter() as var:
            x.var(dim=dims, correction=0)
        with troofline.CostCounter() as std:
            x.std(dim=dims)
    want = _jax_one_op_cost(lambda v: jnp.var(v, axis=dims), shape)
    assert var.flops == std.flops == want["flops"]


def test_an_op_that_returns_its_input_moves_no_bytes():
    x = torch.ones(64, 64)
    with torch.inference_mode():
        with troofline.CostCounter() as c:
            y = x.to(x.dtype)
            x.contiguous()
        with troofline.CostCounter() as cast:
            x.to(torch.float64)
    assert y is x and c.bytes == 0 and c.flops == 0
    assert cast.bytes == x.numel() * (4 + 8) and cast.flops == x.numel()


# -- the port's own behaviour -------------------------------------------------

_SMALL_RAFT = {"device": "cpu", "side_size": 64, "iters": 2}


def test_certify_identity_is_bit_exact(tmp_path):
    """No flip: both arms run the YAML default, so every seam is equal to
    the bit, and the verdict file is the returned document."""
    assert tparity.main(["certify", "--family", "raft", "--frames", "4",
                         "--out", str(tmp_path), "--set", "device=cpu",
                         "--set", "side_size=64", "--set", "iters=2"]) == 0
    doc = json.loads((tmp_path / tparity.VERDICT_FILENAME).read_text())
    assert doc["verdict"] == "PASS" and doc["first_drift"] is None
    assert doc["ref"] == doc["cand"] == {} and doc["flip"] is None
    for seam in tparity.SEAMS:
        m = doc["seams"][seam]
        assert m["pairs"] > 0 and m["max_abs"] == 0.0 and m["cos"] == 1.0


@pytest.mark.parametrize("seam", ["transform", "backbone"])
def test_certify_perturb_fails_at_that_seam(tmp_path, seam):
    doc = tparity.certify("raft", frames=4, out_dir=str(tmp_path),
                          perturb={seam: 5.0}, extra_overrides=_SMALL_RAFT)
    assert doc["verdict"] == "FAIL" and doc["first_drift"] == seam
    upstream = tparity.SEAMS[:tparity.SEAMS.index(seam)]
    assert all(doc["seams"][s]["ok"] for s in upstream)


def test_certify_restores_the_precision_latch(tmp_path):
    latch = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tparity.certify("raft", frames=3, out_dir=str(tmp_path),
                        extra_overrides=_SMALL_RAFT)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = latch


@pytest.fixture
def observer(tmp_path, monkeypatch):
    monkeypatch.setenv("VFT_ROOFLINE_PEAK", "0.05,10")
    obs = troofline.RooflineObserver(str(tmp_path), default_family="toy",
                                     run_id="test")
    assert obs.start() is obs
    assert tcl.work_hook is not None
    yield obs
    obs.close(write=False)
    assert troofline.active() is None and tcl.work_hook is None


def _toy_flops(n: int) -> int:
    """The toy linear's card for ``n`` rows, as XLA counts it: the dot's
    2 M N K and one FLOP an element for the bias add."""
    return 2 * n * 16 * 16 + n * 16


def _toy_runner():
    from video_features_tpu_torch.parallel.mesh import (DataParallelApply,
                                                        get_mesh)
    return DataParallelApply(lambda m, x: m(x), torch.nn.Linear(16, 16),
                             get_mesh("cpu"))


def test_distinct_shapes_get_distinct_cards(observer, tmp_path):
    runner = _toy_runner()
    for n in (2, 4, 4):
        runner(np.ones((n, 16), np.float32))
    doc = observer.close()
    fam = doc["families"]["toy"]
    cards = {tuple(c["shape"]): c for c in fam["programs"]}
    assert {s: c["dispatches"] for s, c in cards.items()} == {
        (2, 16): 1, (4, 16): 2}
    assert cards[(4, 16)]["flops"] == _toy_flops(4)
    # the one uncounted dispatch is the family's timed work
    assert fam["flops_total"] == _toy_flops(4)
    assert fam["forward_calls"] == 1 and fam["forward_s"] > 0
    assert fam["mfu"] == pytest.approx(
        fam["flops_total"] / 1e12 / fam["forward_s"] / 0.05, abs=1e-4)
    assert troofline.validate_roofline(doc) == []
    assert (tmp_path / troofline.ROOFLINE_FILENAME).exists()


@pytest.mark.parametrize("shapes", [(4, 4, 4), (2, 4)])
def test_counted_windows_stand_in_only_alone(observer, monkeypatch,
                                             shapes):
    """The counting pass's windows (slowed here by 0.2 s) leave
    ``forward_s`` when uncounted dispatches exist, and are the family's
    time, with one dispatch's work per card, when none does."""
    enter = troofline.CostCounter.__enter__

    def slow_enter(self):
        time.sleep(0.2)
        return enter(self)

    monkeypatch.setattr(troofline.CostCounter, "__enter__", slow_enter)
    runner = _toy_runner()
    for n in shapes:
        runner(np.ones((n, 16), np.float32))
    fam = observer.close(write=False)["families"]["toy"]
    assert fam["dispatches"] == len(shapes)
    if shapes == (4, 4, 4):
        assert fam["forward_calls"] == 2 and fam["forward_s"] < 0.2
        assert fam["flops_total"] == 2 * _toy_flops(4)
    else:
        assert fam["forward_calls"] == 2 and fam["forward_s"] >= 0.4
        assert fam["flops_total"] == _toy_flops(2) + _toy_flops(4)


def test_observe_is_noop_when_off():
    assert troofline.active() is None and tcl.work_hook is None
    assert troofline.snapshot() == {} and tparity.snapshot() == {}
    out = _toy_runner()(np.ones((4, 16), np.float32))
    assert out.shape == (4, 16)


def test_peak_env_registry_and_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VFT_ROOFLINE_PEAK", "12.5,400")
    env = troofline.peak_for_device()
    assert env["source"] == "env" and env["peak_tflops"] == 12.5
    assert env["peak_gbps"] == 400.0 and env["device_kind"] == "cpu"
    monkeypatch.setenv("VFT_ROOFLINE_PEAK", "nonsense")
    with pytest.raises(ValueError, match="VFT_ROOFLINE_PEAK"):
        troofline.peak_for_device()
    monkeypatch.delenv("VFT_ROOFLINE_PEAK")
    reg = troofline.peak_for_device(device_kind="NVIDIA H100 80GB HBM3",
                                    platform="gpu", measure=False)
    assert reg["source"] == "registry" and reg["platform"] == "gpu"
    calls = []

    def fake():
        calls.append(1)
        return {"peak_tflops": 3.0, "peak_gbps": 20.0}

    kw = dict(device_kind="Some Card", platform="gpu",
              cache_dir=str(tmp_path), measure_fn=fake)
    assert troofline.peak_for_device(measure=False, **kw) is None
    first = troofline.peak_for_device(**kw)
    second = troofline.peak_for_device(**kw)
    assert first["source"] == "microbench" and first["peak_tflops"] == 3.0
    assert second["source"] == "microbench (cached)" and len(calls) == 1


def test_measure_peak_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        troofline.measure_peak()


def test_ensure_for_extractor_homes_an_observer(tmp_path):
    """A library caller's extractor with ``roofline=true`` gets an observer
    on its output dir (first wins); ``roofline=false`` gets none."""
    class Ext:
        feature_type = "toy"
        output_path = str(tmp_path)

        def __init__(self, on):
            self.args = {"roofline": on}

    troofline.ensure_for_extractor(Ext(False))
    assert troofline.active() is None
    troofline.ensure_for_extractor(Ext(True))
    obs = troofline.active()
    try:
        assert obs is not None and obs.path == str(
            tmp_path / troofline.ROOFLINE_FILENAME)
        troofline.ensure_for_extractor(Ext(True))
        assert troofline.active() is obs
    finally:
        obs.close()
    assert (tmp_path / troofline.ROOFLINE_FILENAME).exists()


def test_transform_tap_only_with_parity(tmp_path):
    """``video_source`` wraps the transform in a ``TransformTap`` only
    under ``parity=true``; with no observer active the tap passes frames
    through untouched."""
    from video_features_tpu_torch.extractors.base import BaseExtractor
    from video_features_tpu_torch.utils import io as vio

    seen = {}

    class Src:
        def __init__(self, path, **kw):
            seen.update(kw)
            self.fps, self.path = 1.0, path

        def __len__(self):
            return 0

    ext = BaseExtractor.__new__(BaseExtractor)
    ext.feature_type, ext.video_decode = "toy", "inline"
    ext.decode_workers, ext.decode_depth = 2, None
    tf = object()
    orig = vio.VideoSource
    vio.VideoSource = Src
    try:
        for on in (False, True):
            ext.parity = on
            seen.clear()
            ext.video_source("v.mp4", transform=tf)
            wrapped = seen["transform"]
            assert isinstance(wrapped, tparity.TransformTap) is on
    finally:
        vio.VideoSource = orig
    frame = np.ones((2, 2, 3), np.uint8)
    assert tparity.TransformTap(None, "v", "toy")(frame) is frame
