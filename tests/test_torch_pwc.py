"""PWC flow and I3D with PWC flow in the port against the JAX package.

Inputs come from numpy seeds; the JAX PWC tree of ``init_params`` (or of a
JAX extractor) is carried into the port by ``pwc_state_from_jax``. Every JAX
call is jitted (JAX bfloat16 op by op on the CPU is slow, and the jitted
function is the one the JAX extractors run). Tolerances:

- the cost volume against ``cost_volume_xla``: float32 within 1e-6; from
  bfloat16 inputs within one bfloat16 ulp of the output plus the error
  bound of the two float32 channel sums (both take exact float32 products
  and sum them in float32 in another order: C * 2^-24 * mean |product|
  each, which only matters where the terms cancel to near zero);
- ``bilinear_warp`` within 1e-5 in float32 and one bfloat16 ulp in
  bfloat16, and its mask equal everywhere (read off a constant-one channel);
- ``PWCNet`` float32 flows within 1e-3 px on a 64x64 pair and a 72x100 pair
  (the internal resize); bfloat16 flows closer to JAX bfloat16 than JAX
  float32 is (max and median abs) and within 2.0 px and cosine 0.98 of JAX
  float32 (the JAX package's own certification band,
  ``telemetry/parity.py``);
- ``feature_type=pwc`` end to end on the sample video: float32 flows within
  1e-3 px, ``fps`` and ``timestamps_ms`` exact;
- ``feature_type=i3d flow_type=pwc`` on one 10-frame stack, as
  tests/test_torch_slice.py holds the RAFT slice: features within 1e-2,
  quantised crops equal but for at most 0.1% of elements one step apart,
  timestamps exact;
- I3D in bfloat16 closer to JAX bfloat16 than JAX float32 is.

The CLI at both families' YAML defaults is in tests/test_torch_pwc_cli.py.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.kernels.cost_volume import cost_volume_xla
from video_features_tpu.models import i3d as ji3d
from video_features_tpu.models import pwc as jpwc
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.extractors import i3d_flow as tflow
from video_features_tpu_torch.kernels.cost_volume import cost_volume
from video_features_tpu_torch.models import i3d as ti3d
from video_features_tpu_torch.models import pwc as tpwc
from video_features_tpu_torch.models.common import cast_floating_
from video_features_tpu_torch.weights.bridge import (i3d_state_from_jax,
                                                      pwc_state_from_jax,
                                                      seeded_init_)

from .test_torch_slice import FPS, _FakeSource, _frames


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each value (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_params():
    # jit only makes the flax init compile once instead of op by op
    return jax.tree_util.tree_map(np.asarray, jax.jit(jpwc.init_params)())


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 1, 4), (1, 2, 3, 5),
                                   (2, 9, 12, 32)])
def test_cost_volume_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    f1, f2 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(cost_volume_xla)(f1, f2))
    got = cost_volume(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    assert got.shape == want.shape == shape[:3] + (81,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # channel (dy + 4) * 9 + (dx + 4), dy slowest, zero outside the plane
    b, h, w, c = shape
    dy, dx = 1, -2
    ref = np.zeros((b, h, w), np.float32)
    for y in range(h):
        for x in range(w):
            if 0 <= y + dy < h and 0 <= x + dx < w:
                ref[:, y, x] = (f1[:, y, x] * f2[:, y + dy, x + dx]).mean(-1)
    np.testing.assert_allclose(got[..., (dy + 4) * 9 + dx + 4], ref,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 2, 3, 5),
                                   (2, 16, 24, 96)])
def test_cost_volume_bfloat16_within_one_ulp(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    f1, f2 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(cost_volume_xla)(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    ).astype(jnp.float32))
    got = cost_volume(torch.from_numpy(f1).bfloat16(),
                      torch.from_numpy(f2).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    c = shape[-1]
    terms = cost_volume(
        torch.from_numpy(np.abs(f1)).bfloat16().double(),
        torch.from_numpy(np.abs(f2)).bfloat16().double()).numpy()
    sum_order = 2 * c * 2.0 ** -24 * terms
    diff = np.abs(got - want)
    assert np.all(diff <= _bf16_ulp(want) + sum_order), diff.max()
    assert (diff > _bf16_ulp(want)).mean() < 1e-3


def _warp_case(case: str, dtype: str):
    """NHWC features with a constant-one last channel (its warped value is
    the mask times the interpolated ones) and an NHWC flow."""
    rng = np.random.default_rng({"random": 0, "integers": 1, "edges": 2,
                                 "outside": 3}[case])
    b, h, w, c = 2, 9, 13, 5
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    feat[..., -1] = 1.0
    if dtype == "bfloat16":
        feat = np.asarray(jnp.asarray(feat, jnp.bfloat16).astype(jnp.float32))
    if case == "random":
        flow = rng.uniform(-4.0, 4.0, size=(b, h, w, 2))
    elif case == "integers":
        flow = rng.integers(-3, 4, size=(b, h, w, 2)).astype(np.float64)
    elif case == "edges":
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        # land exactly on the last column / row, just inside and just
        # outside the first, and a hair short of the ones threshold
        tx = rng.choice([w - 1, 0, -1e-3, 1e-3, w - 1 + 1e-3, -0.0005,
                         w - 1.0009], size=(b, h, w))
        ty = rng.choice([h - 1, 0, -1e-3, 1e-3, h - 1 + 1e-3, -0.0005,
                         h - 1.0009], size=(b, h, w))
        flow = np.stack([tx - gx, ty - gy], -1)
    else:
        flow = rng.choice([-1e3, 1e3, 250.5, -7.25], size=(b, h, w, 2))
        flow[0, :3] = rng.uniform(-2.0, 2.0, size=(3, w, 2))
    return feat, flow.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "integers", "edges", "outside"])
def test_bilinear_warp_matches_jax(case, dtype):
    feat, flow = _warp_case(case, dtype)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = np.asarray(jax.jit(jpwc.bilinear_warp)(
        jnp.asarray(feat, jdt), flow).astype(jnp.float32))
    tfeat = torch.from_numpy(feat).permute(0, 3, 1, 2).to(getattr(torch,
                                                                  dtype))
    got = tpwc.bilinear_warp(tfeat, torch.from_numpy(flow).permute(0, 3, 1, 2))
    assert got.dtype == tfeat.dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got[..., -1] != 0, want[..., -1] != 0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    masked = (want[..., -1] == 0).mean()
    if case == "outside":
        assert masked > 0.5
    elif case == "edges":
        assert 0.1 < masked < 0.9


def _pair(h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    b = np.clip(np.roll(a, 2, axis=2) + rng.normal(0, 5, a.shape), 0, 255)
    return a, b.astype(np.float32)


@pytest.fixture(scope="module")
def pwc_flows(jax_params):
    """JAX float32 flows on a 64x64 and a 72x100 pair, and JAX bfloat16 on
    the 64x64 one; the port's model on the same params."""
    out = {}
    for dtype, shapes in ((jnp.float32, [(64, 64), (72, 100)]),
                          (jnp.bfloat16, [(64, 64)])):
        fn = jax.jit(lambda p, x, y, dt=dtype: jpwc.PWCNet(dtype=dt).apply(
            {"params": p}, x, y))
        for hw in shapes:
            out[(jnp.dtype(dtype).name, hw)] = np.asarray(
                fn(jax_params, *_pair(*hw, sum(hw))))
    return out


def _port_pwc(jax_params, dtype=torch.float32):
    model = tpwc.PWCNet(dtype).eval()
    model.load_state_dict(pwc_state_from_jax(jax_params), strict=True)
    return model


@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_pwc_flow_matches_jax(jax_params, pwc_flows, hw):
    a, b = _pair(*hw, sum(hw))
    with torch.inference_mode():
        got = _port_pwc(jax_params)(torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    want = pwc_flows[("float32", hw)]
    assert got.shape == want.shape == (1,) + hw + (2,)
    assert got.dtype == np.float32 and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_pwc_bfloat16_flow_matches_jax(jax_params, pwc_flows):
    a, b = _pair(64, 64, 128)
    with torch.inference_mode():
        got = _port_pwc(jax_params, torch.bfloat16)(
            torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    jb, jf = pwc_flows[("bfloat16", (64, 64))], pwc_flows[("float32",
                                                              (64, 64))]
    ours, theirs = np.abs(got - jb), np.abs(jb - jf)
    assert ours.max() < theirs.max() and np.median(ours) < np.median(theirs)
    assert np.abs(got - jf).max() <= 2.0 and _cos(got, jf) >= 0.98


def test_pwc_bfloat16_keeps_float32_parts(monkeypatch):
    """In bfloat16 the weights stay float32; the flow heads and the refiner's
    last conv see float32 inputs, the upflow runs in float32, the warp gets
    a float32 flow; every other conv runs in bfloat16."""
    model = tpwc.PWCNet(torch.bfloat16).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = {}
    for name, mod in model.named_modules():
        if isinstance(mod, tpwc.Conv2d):
            mod.register_forward_hook(
                lambda m, inp, out, name=name: seen.__setitem__(
                    name, (inp[0].dtype, out.dtype)))
    upconv, warp = [], []
    orig_up, orig_warp = tpwc._conv_transpose, tpwc.bilinear_warp
    monkeypatch.setattr(tpwc, "_conv_transpose", lambda m, x: upconv.append(
        (m.weight.shape[0], x.dtype)) or orig_up(m, x))
    monkeypatch.setattr(tpwc, "bilinear_warp", lambda f, fl: warp.append(
        (f.dtype, fl.dtype)) or orig_warp(f, fl))
    a, b = _pair(64, 64, 5)
    with torch.inference_mode():
        flow = model(torch.from_numpy(a), torch.from_numpy(b))
    assert flow.dtype == torch.float32
    heads = {f"{n}.moduleSix.0" for _, n in tpwc.LEVELS} | {
        "moduleRefiner.moduleMain.12"}
    assert heads <= set(seen) and len(seen) == 18 + 5 * 6 + 7
    for name, dtypes in seen.items():
        want = torch.float32 if name in heads else torch.bfloat16
        assert dtypes == (want, want), name
    # per decoder below level 6: upflow (2 inputs) float32, upfeat bfloat16
    assert sorted(upconv, key=str) == sorted(
        [(2, torch.float32)] * 4 + [(c, torch.bfloat16) for c in
                                    (529, 661, 629, 597)], key=str)
    assert warp == [(torch.bfloat16, torch.float32)] * 4


def test_pwc_stacks_per_forward_matches_jax():
    from video_features_tpu.extractors import i3d_flow as jflow
    assert jflow._flow_pyramid_budget() == tflow._FLOW_BUDGET_FALLBACK
    cpu = torch.device("cpu")
    ks = set()
    for t, h, w in [(64, 256, 341), (64, 480, 854), (16, 64, 64),
                    (64, 720, 1280), (10, 256, 256), (32, 1080, 1920),
                    (64, 300, 400)]:
        for bpe in (2, 4):
            k = tflow._pwc_stacks_per_forward(t, h, w, cpu, bytes_per_el=bpe)
            assert k == jflow._pwc_stacks_per_forward(t, h, w,
                                                      bytes_per_el=bpe)
            ks.add(k)
    assert ks == {1, 2, 4}


def _family_overrides(tmp, sample_video):
    return {"feature_type": "pwc", "video_paths": sample_video,
            "device": "cpu", "precision": "float32", "resize": "host",
            "side_size": 64, "batch_size": 2, "extraction_total": 5,
            "allow_random_weights": True, "on_extraction": "print",
            "output_path": str(tmp / "out"), "tmp_path": str(tmp / "tmp")}


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory, sample_video, jax_params):
    from video_features_tpu.config import load_config, sanity_check
    from video_features_tpu.extractors.pwc import ExtractPWC as JaxPWC
    from video_features_tpu_torch.extractors.pwc import ExtractPWC

    tmp = tmp_path_factory.mktemp("pwc_family")
    over = _family_overrides(tmp, sample_video)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        mp.setattr(jpwc, "init_params", lambda: jax_params)
        jcfg = load_config("pwc", over)
        sanity_check(jcfg)
        jex = JaxPWC(jcfg)
        jfeats = jex.extract(sample_video)
    finally:
        mp.undo()
    tcfg = tconfig.load_config("pwc", over)
    tconfig.sanity_check(tcfg)
    tex = ExtractPWC(tcfg)
    tex.model.load_state_dict(pwc_state_from_jax(jex.runner.params),
                              strict=True)
    return jfeats, tex.extract(sample_video), tex


def test_family_flow_matches_jax(family_runs):
    jfeats, tfeats, tex = family_runs
    assert tex.resize_mode == "host" and tex.model.dtype == torch.float32
    assert tfeats["pwc"].dtype == np.float32
    assert tfeats["pwc"].shape == jfeats["pwc"].shape == (4, 2, 64, 85)
    np.testing.assert_allclose(tfeats["pwc"], jfeats["pwc"], atol=1e-3,
                               rtol=0)


def test_family_fps_and_timestamps_match_jax(family_runs):
    jfeats, tfeats, tex = family_runs
    assert float(tfeats["fps"]) == float(jfeats["fps"])
    np.testing.assert_array_equal(tfeats["timestamps_ms"],
                                  jfeats["timestamps_ms"])
    assert len(tfeats["timestamps_ms"]) == len(tfeats["pwc"]) + 1
    assert tex.output_feat_keys == ["pwc", "fps", "timestamps_ms"]


def _i3d_overrides(tmp):
    return {"feature_type": "i3d", "video_paths": "synthetic.mp4",
            "device": "cpu", "stack_size": 10, "step_size": 10,
            "clip_batch_size": 1, "resize": "device", "precision": "float32",
            "allow_random_weights": True, "on_extraction": "print",
            "output_path": str(tmp / "out"), "tmp_path": str(tmp / "tmp")}


@pytest.fixture(scope="module")
def i3d_runs(tmp_path_factory, jax_params):
    """The JAX ``ExtractI3D`` at its default ``flow_type`` (pwc) on one
    10-frame stack, and the port's on the same weights: PWC's
    ``init_params`` tree bridged across, both I3D streams from checkpoints
    in the reference's layout (the port's seeded init), which both packages
    read through their weights paths; the checkpoints are removed when the
    module's tests are done."""
    from video_features_tpu.config import load_config, sanity_check
    from video_features_tpu.extractors.i3d import ExtractI3D as JaxI3D
    from video_features_tpu_torch.extractors.i3d import ExtractI3D

    tmp = tmp_path_factory.mktemp("i3d_pwc")
    over = _i3d_overrides(tmp)
    for key, channels, seed in (("weights_path", 3, 21),
                                ("flow_weights_path", 2, 22)):
        over[key] = str(tmp / f"{key}.pt")
        torch.save(seeded_init_(ti3d.I3D(400, in_channels=channels),
                                seed).state_dict(), over[key])
    frames = _frames()
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        mp.setattr(jpwc, "init_params", lambda: jax_params)
        jcfg = load_config("i3d", over)
        sanity_check(jcfg)
        jex = JaxI3D(jcfg)
        assert jex.flow_type == "pwc"
        jex.video_source = lambda *a, **k: _FakeSource(frames)
        jfeats = jex.extract("synthetic.mp4")
        group = np.stack([f for f, _, _ in frames])[None]
        resized = jex._runners_for(240, 320)[0].dispatch(group)[:1]
        jcrops = np.asarray(jex._flow_stream._device_flow(resized))
        jresized = np.array(resized)
    finally:
        mp.undo()

    tcfg = tconfig.load_config("i3d", over)
    tconfig.sanity_check(tcfg)
    tex = ExtractI3D(tcfg)
    assert tex.flow_type == "pwc" and tex.flow_stream.raft is None
    tex.flow_stream.pwc.load_state_dict(
        pwc_state_from_jax(jex._flow_stream.pair_runner.params), strict=True)
    tfeats = tex.extract_frames(iter(frames), FPS)
    with torch.inference_mode():
        tcrops = tex.flow_stream.quantized_flow(
            torch.from_numpy(jresized)).numpy()
    yield (jfeats, tfeats, jcrops, tcrops, tex,
           jex._flow_stream.runner.params)
    for key in ("weights_path", "flow_weights_path"):
        os.unlink(over[key])  # 97 MB, once the module is done


def test_i3d_pwc_quantized_flow_crops(i3d_runs):
    _, _, jcrops, tcrops, tex, _ = i3d_runs
    assert jcrops.shape == tcrops.shape == (1, 10, 224, 224, 2)
    diff = np.abs(jcrops - tcrops)
    assert np.all((diff == 0) | (diff == 1)), np.unique(diff)
    assert diff.mean() <= 1e-3, diff.mean()
    assert tex.flow_stream.forwards == 2  # extract_frames, then the crops


@pytest.mark.parametrize("key", ["rgb", "flow"])
def test_i3d_pwc_features(i3d_runs, key):
    jfeats, tfeats = i3d_runs[:2]
    assert tfeats[key].shape == jfeats[key].shape == (1, 1024)
    np.testing.assert_allclose(tfeats[key], jfeats[key], atol=1e-2, rtol=0)


def test_i3d_pwc_timestamps_and_keys(i3d_runs):
    jfeats, tfeats, _, _, tex, _ = i3d_runs
    np.testing.assert_array_equal(tfeats["timestamps_ms"],
                                  jfeats["timestamps_ms"])
    assert float(tfeats["fps"]) == float(jfeats["fps"]) == FPS
    assert tex.output_feat_keys == ["rgb", "flow", "fps", "timestamps_ms"]


def test_i3d_bfloat16_matches_jax(i3d_runs):
    """The flow I3D on the JAX quantised crops, in bfloat16 on cast weights
    (input cast, then ScaleTo1_1, features float32): closer to JAX bfloat16
    than JAX float32 is."""
    from video_features_tpu.extractors.i3d import _i3d_forward
    jcrops, flow_params = i3d_runs[2], i3d_runs[5]
    model = ji3d.I3D(num_classes=400)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda p, x, dt=dt: _i3d_forward(model, dt, True, p, x))
        want[jnp.dtype(dt).name] = np.asarray(
            fn(cast_floating(flow_params, dt), jcrops))
    port = ti3d.I3D(400, in_channels=2)
    port.load_state_dict(i3d_state_from_jax(flow_params), strict=True)
    cast_floating_(port, torch.bfloat16).eval()
    with torch.inference_mode():
        got = tflow.i3d_forward(port, torch.from_numpy(jcrops),
                                torch.bfloat16).numpy()
    assert got.dtype == np.float32 and got.shape == (1, 1024)
    jb, jf = want["bfloat16"], want["float32"]
    ours, theirs = np.abs(got - jb), np.abs(jb - jf)
    assert ours.max() < theirs.max() and np.median(ours) < np.median(theirs)
    assert _cos(got, jf) >= 0.99


def test_i3d_rejects_unknown_flow_type(tmp_path):
    """Flow types other than raft and pwc raise, as in the JAX
    ``FlowStream``; the rgb stream alone needs none."""
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    over = dict(_i3d_overrides(tmp_path), flow_type="flownet")
    with pytest.raises(NotImplementedError, match="raft/pwc"):
        ExtractI3D(tconfig.load_config("i3d", dict(over, streams="flow")))
    assert ExtractI3D(tconfig.load_config(
        "i3d", dict(over, streams="rgb"))).flow_stream is None
