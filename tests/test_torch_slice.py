"""The i3d + RAFT slice of the port against the JAX package, end to end.

One 10-frame stack of seeded synthetic 240x320 uint8 frames goes through
the JAX ``ExtractI3D`` (CPU, ``flow_type=raft``, ``flow_iters=2``,
``resize=device``) and through the port's ``extract_frames`` with the same
weights carried across. Tolerances: quantised flow crops from the same
resized frames may differ in at most 0.1% of elements and only by exactly
one quantisation step (a flow within ~1e-5 px of a rounding boundary can
land either side); each side's own device resize within 1 LSB (the f32 sum
order decides a rounding between the two passes); ``rgb`` and ``flow``
features atol 1e-2 (the value tier); ``timestamps_ms`` exact.

The crops are compared on the JAX side's resized frames because those 1-LSB
resize differences (about 0.006% of pixels here) move a random-weight RAFT's
flow by far more than 1e-5 px, and flip about 0.3% of the quantised crops.

Also here: the port's host-side pieces against the JAX package's (config,
decode plan, resize, sinks) and the import guard; the run-plane and
serving keys on the slice's extractor and the CLI on the sample are in
tests/test_torch_slice_planes.py.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import i3d as ji3d
from video_features_tpu.models import raft as jraft
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.extractors import i3d_flow as tflow
from video_features_tpu_torch.ops import preprocess as tpp
from video_features_tpu_torch.utils import io as tio
from video_features_tpu_torch.utils import sinks as tsinks
from video_features_tpu_torch.weights.bridge import (i3d_state_from_jax,
                                                      raft_state_from_jax)

REPO = Path(__file__).resolve().parents[1]
FPS = 25.0


def _frames(n=11, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    out = []
    for t in range(n):
        f = np.stack([127 + 100 * np.sin(xx / 23 + t / 5),
                      127 + 100 * np.sin(yy / 17 - t / 7),
                      127 + 100 * np.sin((xx + yy) / 31 + t / 3)], -1)
        f += rng.normal(0, 8, f.shape)
        out.append((f.clip(0, 255).astype(np.uint8), t / FPS * 1000.0, t))
    return out


class _FakeSource:
    def __init__(self, frames):
        self._frames, self.fps = frames, FPS

    def frames(self):
        return iter(self._frames)


def _overrides(tmp):
    return {"feature_type": "i3d", "video_paths": "synthetic.mp4",
            "device": "cpu", "flow_type": "raft", "flow_iters": 2,
            "stack_size": 10, "step_size": 10, "clip_batch_size": 1,
            "resize": "device", "precision": "float32",
            "allow_random_weights": True, "on_extraction": "print",
            "output_path": str(tmp / "out"), "tmp_path": str(tmp / "tmp")}


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    from video_features_tpu.config import load_config, sanity_check
    from video_features_tpu.extractors.i3d import ExtractI3D as JaxI3D
    from video_features_tpu_torch.extractors.i3d import ExtractI3D

    tmp = tmp_path_factory.mktemp("slice")
    frames = _frames()
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        # jit only makes the flax inits compile once instead of op by op
        mp.setattr(ji3d, "init_params",
                   jax.jit(ji3d.init_params, static_argnums=0))
        mp.setattr(jraft, "init_params",
                   jax.jit(jraft.init_params, static_argnums=0))
        jcfg = load_config("i3d", _overrides(tmp))
        sanity_check(jcfg)
        jex = JaxI3D(jcfg)
        jex.video_source = lambda *a, **k: _FakeSource(frames)
        jfeats = jex.extract("synthetic.mp4")
        group = np.stack([f for f, _, _ in frames])[None]
        resized = jex._runners_for(240, 320)[0].dispatch(group)[:1]
        jcrops = np.asarray(jex._flow_stream._device_flow(resized))
        jresized = np.array(resized)
    finally:
        mp.undo()

    tcfg = tconfig.load_config("i3d", _overrides(tmp))
    tconfig.sanity_check(tcfg)
    tex = ExtractI3D(tcfg)
    tex.rgb_model.load_state_dict(
        i3d_state_from_jax(jex.runners["rgb"].params), strict=True)
    tex.flow_stream.raft.load_state_dict(
        raft_state_from_jax(jex._flow_stream.pair_runner.params), strict=True)
    tex.flow_stream.i3d.load_state_dict(
        i3d_state_from_jax(jex._flow_stream.runner.params), strict=True)
    tfeats = tex.extract_frames(iter(frames), FPS)
    with torch.inference_mode():
        tresized = tex._resizer(240, 320, torch.device("cpu"))(
            torch.from_numpy(group)).numpy()
        tcrops = tex.flow_stream.quantized_flow(
            torch.from_numpy(jresized)).numpy()
    return jfeats, tfeats, jcrops, tcrops, tex, jresized, tresized


def test_slice_device_resize(slice_runs):
    jresized, tresized = slice_runs[5:]
    assert jresized.shape == tresized.shape == (1, 11, 256, 341, 3)
    diff = np.abs(jresized.astype(int) - tresized.astype(int))
    assert diff.max() <= 1 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


def test_slice_quantized_flow_crops(slice_runs):
    _, _, jcrops, tcrops, tex = slice_runs[:5]
    assert jcrops.shape == tcrops.shape == (1, 10, 224, 224, 2)
    diff = np.abs(jcrops - tcrops)
    assert np.all((diff == 0) | (diff == 1)), np.unique(diff)
    assert diff.mean() <= 1e-3, diff.mean()
    assert tcrops.min() >= 0 and tcrops.max() <= 256
    assert tex.flow_stream.forwards == 2  # extract_frames, then the crops


@pytest.mark.parametrize("key", ["rgb", "flow"])
def test_slice_features(slice_runs, key):
    jfeats, tfeats = slice_runs[:2]
    assert tfeats[key].shape == jfeats[key].shape == (1, 1024)
    np.testing.assert_allclose(tfeats[key], jfeats[key], atol=1e-2, rtol=0)


def test_slice_timestamps_and_keys(slice_runs):
    jfeats, tfeats, _, _, tex = slice_runs[:5]
    np.testing.assert_array_equal(tfeats["timestamps_ms"],
                                  jfeats["timestamps_ms"])
    assert float(tfeats["fps"]) == float(jfeats["fps"]) == FPS
    assert tex.output_feat_keys == ["rgb", "flow", "fps", "timestamps_ms"]


def test_slice_packed_lookup_matches_fused(slice_runs, tmp_path):
    """corr_lookup_impl=packed (the packed kernel's plain version here) gives
    the fused path's features on the same frames and weights, within the
    value tier (a flow within ~1e-5 px of a quantisation boundary can land
    either side)."""
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    tfeats, tex = slice_runs[1], slice_runs[4]
    cfg = tconfig.load_config("i3d", dict(_overrides(tmp_path),
                                          corr_lookup_impl="packed"))
    tconfig.sanity_check(cfg)
    packed = ExtractI3D(cfg)
    assert packed.flow_stream.raft.corr_lookup_impl == "packed"
    packed.rgb_model.load_state_dict(tex.rgb_model.state_dict())
    packed.flow_stream.raft.load_state_dict(tex.flow_stream.raft.state_dict())
    packed.flow_stream.i3d.load_state_dict(tex.flow_stream.i3d.state_dict())
    got = packed.extract_frames(iter(_frames()), FPS)
    for key in ("rgb", "flow"):
        np.testing.assert_allclose(got[key], tfeats[key], atol=1e-2, rtol=0)
    np.testing.assert_array_equal(got["timestamps_ms"],
                                  tfeats["timestamps_ms"])


def test_crop_quantize_matches_jax():
    """Floor-rule crop of an odd padded field, clamp, round half to even,
    values up to 256.0 kept as floats."""
    from video_features_tpu.extractors.i3d_flow import _crop_quantize
    rng = np.random.default_rng(7)
    flow = rng.uniform(-25, 25, size=(2, 261, 349, 2)).astype(np.float32)
    flow[0, 130, 174, 0] = 20.0   # 255.5 -> 256 (half to even)
    flow[0, 130, 175, 1] = -20.0
    flow[1, 140, 180, 0] = 0.0784313725  # 128.5 -> 128
    got = tflow._crop_quantize(torch.from_numpy(flow), 224).numpy()
    want = np.asarray(_crop_quantize(jnp.asarray(flow), 224))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.max() == 256.0


def test_stacks_per_forward_sizes_by_pyramid_bytes():
    cpu = torch.device("cpu")
    # 64 frames at 256x344: 32x43 grid, 1812 cells/query, ~0.64 GB/stack
    assert tflow.pyramid_cells(32, 43) == 1376 + 336 + 80 + 20
    assert tflow._stacks_per_forward(64, 256, 341, cpu) == 4
    assert tflow._stacks_per_forward(64, 480, 854, cpu) == 1
    assert tflow._stacks_per_forward(16, 64, 64, cpu) == 4  # cap wins


def test_device_resize_matches_jax_and_pil():
    from video_features_tpu.ops import preprocess as jpp
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(2, 3, 60, 80, 3), dtype=np.uint8)
    ow, oh = tpp.resize_edge_size(80, 60, 32)
    assert (ow, oh) == jpp.resize_edge_size(80, 60, 32) == (42, 32)
    np.testing.assert_array_equal(tpp.pil_resize_matrix(60, 32),
                                  jpp.pil_resize_matrix(60, 32))
    got = tpp.make_device_resizer(60, 80, oh, ow, torch.device("cpu"))(
        torch.from_numpy(frames)).numpy()
    want = np.asarray(jpp.make_device_resizer(60, 80, oh, ow)(
        jnp.asarray(frames)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    pil = tpp.pil_resize(frames[0, 0], 32)
    np.testing.assert_array_equal(pil, jpp.pil_resize(frames[0, 0], 32))
    assert np.abs(got[0, 0].astype(int) - pil.astype(int)).max() <= 2


@pytest.mark.parametrize("n,src,dst", [(355, 19.62, 1.0), (355, 19.62, 3.0),
                                       (100, 30.0, 15.0), (10, 25.0, 50.0),
                                       (3, 30.0, 1.0)])
def test_fps_plan_matches_jax(n, src, dst):
    from video_features_tpu.utils import io as jio
    np.testing.assert_array_equal(tio.fps_filter_map(n, src, dst),
                                  jio.fps_filter_map(n, src, dst))
    for kw in ({"fps": dst}, {"total": 7}, {}):
        t = tio.plan_frame_selection(src, n, **kw)
        j = jio.plan_frame_selection(src, n, **kw)
        assert t[0] == j[0] and t[2] == j[2]
        assert (t[1] is None) == (j[1] is None)
        if t[1] is not None:
            np.testing.assert_array_equal(t[1], j[1])


def test_video_source_matches_jax(sample_video):
    from video_features_tpu.utils import io as jio
    t = list(tio.VideoSource(sample_video, fps=2).frames())
    j = list(jio.VideoSource(sample_video, fps=2).frames())
    assert len(t) == len(j) > 0
    for (tf, tt, ti), (jf, jt, ji) in zip(t, j):
        assert (tt, ti) == (jt, ji)
        np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("sink", ["save_numpy", "save_pickle"])
def test_sinks_write_and_skip(tmp_path, sink):
    feats = {"rgb": np.ones((2, 4), np.float32), "fps": np.array(25.0)}
    assert not tsinks.is_already_exist(sink, str(tmp_path), "a/v1.mp4",
                                       list(feats))
    tsinks.action_on_extraction(feats, "a/v1.mp4", str(tmp_path), sink)
    ext = tsinks.EXTS[sink]
    assert sorted(os.listdir(tmp_path)) == [f"v1_fps{ext}", f"v1_rgb{ext}"]
    assert tsinks.is_already_exist(sink, str(tmp_path), "a/v1.mp4",
                                   list(feats))
    (tmp_path / f"v1_rgb{ext}").write_bytes(b"torn")
    assert not tsinks.is_already_exist(sink, str(tmp_path), "a/v1.mp4",
                                       list(feats))


@pytest.mark.parametrize("key,value", [
    ("fps_mode", "reencode"), ("show_pred", True)],
    ids=["fps_mode-reencode", "show_pred-True"])
def test_unported_keys_raise(tmp_path, sample_video, key, value):
    """Both keys once raised as unported; both now run as in JAX. The
    slice's ``show_pred`` (Queue 1 #13) passes the checks; so does
    ``fps_mode=reencode`` (#11), whose source then decodes the re-encoded
    copy under the slice's ``tmp_path`` at select's frame count and
    removes it after the pass."""
    cfg = tconfig.load_config("i3d", dict(_overrides(tmp_path), **{key: value}))
    tconfig.sanity_check(cfg)
    if key != "fps_mode":
        return
    src = tio.VideoSource(sample_video, fps=2.0, fps_mode=cfg.fps_mode,
                          tmp_path=cfg.tmp_path)
    tmp = Path(src.path)
    assert tmp.parent == Path(cfg.tmp_path) and tmp.exists()
    frames = list(src.frames())
    assert len(frames) == len(tio.VideoSource(sample_video, fps=2.0)) > 0
    assert not tmp.exists()


def test_config_matches_jax_parsing_and_namespacing(tmp_path):
    from video_features_tpu import config as jconfig
    argv = ["feature_type=i3d", "flow_type=raft", "stack_size=16",
            "streams=null", "video_paths=[a.mp4,b.mp4]", "x.y=1",
            f"output_path={tmp_path / 'o'}", f"tmp_path={tmp_path / 't'}"]
    assert tconfig.parse_dotlist(argv) == jconfig.parse_dotlist(argv)
    t = tconfig.load_config("i3d", tconfig.parse_dotlist(argv + [
        "device=cpu"]))
    tconfig.sanity_check(t)
    assert t.device == "cpu" and t.stack_size == 16
    assert t.output_path == str(tmp_path / "o" / "i3d")
    for k in ("stack_size", "step_size", "streams", "flow_iters",
              "clip_batch_size", "extraction_fps", "fuse_convc1",
              "corr_lookup_impl", "flow_stack_batch"):
        assert k in jconfig.load_config("i3d") and k in t, k
    with pytest.raises(ValueError, match="shorter than 10"):
        tconfig.sanity_check(tconfig.load_config("i3d", dict(
            _overrides(tmp_path), stack_size=8)))


def test_device_auto_never_falls_back_to_cpu():
    from video_features_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("auto").type == "cuda"
    else:
        for name in ("auto", None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="device=cpu"):
                resolve_device(name)
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_cli_rejects_unported_families():
    """No family is unported since vggish was: each dispatches, and an
    unknown name raises."""
    from video_features_tpu_torch.registry import get_extractor_cls
    with pytest.raises(NotImplementedError, match="Unknown feature_type"):
        get_extractor_cls("nosuch")
    assert get_extractor_cls("vggish").__name__ == "ExtractVGGish"
    assert get_extractor_cls("i3d").__name__ == "ExtractI3D"
    assert get_extractor_cls("raft").__name__ == "ExtractRAFT"
    assert get_extractor_cls("pwc").__name__ == "ExtractPWC"
    assert get_extractor_cls("r21d").__name__ == "ExtractR21D"
    assert get_extractor_cls("s3d").__name__ == "ExtractS3D"
    assert get_extractor_cls("resnet").__name__ == "ExtractResNet"
    assert get_extractor_cls("clip").__name__ == "ExtractCLIP"


def test_port_imports_no_jax_and_no_lazy_host_deps():
    """Every module of the port (the serving plane's ``compile_cache``,
    ``serve``, ``gateway``, ``parallel/queue``, the storage plane's ``gc``
    and ``audit``, the drills' ``loadgen``, ``compare_runs``, the CLI, the
    native writer, the weights store and the lint among them), and
    tests/test_torch_cuda.py, imports under a finder that refuses jax, flax
    and video_features_tpu; importing the
    i3d, raft, pwc, r21d, s3d, resnet and clip extractors and the card-only
    tests pulls in neither cv2 nor PIL nor yaml (nor regex)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "flax", "video_features_tpu"):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import video_features_tpu_torch.extractors.i3d
        import video_features_tpu_torch.extractors.raft
        import video_features_tpu_torch.extractors.pwc
        import video_features_tpu_torch.extractors.r21d
        import video_features_tpu_torch.extractors.s3d
        import video_features_tpu_torch.extractors.resnet
        import video_features_tpu_torch.extractors.clip
        import tests.test_torch_cuda
        lazy = [m for m in ("cv2", "PIL", "yaml", "regex")
                if m in sys.modules]
        assert not lazy, lazy
        import video_features_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        serving = {"video_features_tpu_torch." + m for m in (
            "compile_cache", "serve", "gateway", "parallel.queue", "cli",
            "gc", "audit", "loadgen", "compare_runs", "native",
            "weights.store", "weights.converters", "weights.torch_import",
            "lint", "lint.engine", "lint.rules")}
        assert serving <= set(names), serving - set(names)
        for name in names:
            importlib.import_module(name)
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert int(run.stdout.split()[-1]) >= 92


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of JAX; without a card it exits
    non-zero and prints no result."""
    code = textwrap.dedent("""
        import sys
        import torch

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "flax", "video_features_tpu"):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import chip_smoke
        sys.exit(0 if torch.cuda.is_available() else chip_smoke.main())
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert '"ok"' not in run.stdout
    assert run.returncode == (0 if torch.cuda.is_available() else 2), \
        run.stdout + run.stderr
