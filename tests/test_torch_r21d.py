"""The port's R(2+1)D family against the JAX package's.

Weights: the JAX ``init_params`` tree (its structure and shapes, read with
``jax.eval_shape``) filled with seeded numpy values, batch norms with
non-trivial statistics so a layout bug in the bridge shows, carried across
by ``r21d_state_from_jax``. Tolerances:

- the backbone (r18 at (2, 8, 32, 32, 3), r34 at (1, 8, 32, 32, 3)) and the
  Kinetics ``fc`` logits in float32: atol 5e-4, rtol 5e-4 (the JAX
  package's own torch-oracle bar, tests/test_r21d.py); the port also loads
  tests/torch_oracles.py ``TorchR2Plus1D``'s state dict with
  ``strict=True`` and matches it at the same bar;
- bfloat16: the port closer to JAX bfloat16 than JAX float32 is (at the max
  and the median);
- ``R21DTransform`` on 240x320 frames: the port's of an RGB frame against
  JAX's of the same frame in BGR (the JAX transform reverses the channels
  after its crop): float32 within 1e-5 (JAX resizes with cv2, the port in
  numpy, one float32 ulp apart); uint8 at most 0.01% of the elements off by
  exactly 1 (a value that sits on a rounding tie of ``round(x * 255)`` goes
  either way; on these video-like frames 0-0.005% are, on uniform noise up
  to 0.013%); yuv420 the same count of off-by-one values in the packed
  planes, over the frame's RGB elements; the I420 encoder byte for byte
  (the port's numpy against JAX's cv2) and ``yuv420_packed_to_rgb`` within
  1e-4;
- ``ExtractR21D.extract_frames`` against the JAX extractor on the same 40
  frames (``clip_batch_size=3``): ``stack=step=8`` (5 windows, a ragged
  last group), ``stack=8, step=4`` (the materialised path, 9 windows), and
  a stream too short for one window; features within the value tier's
  atol 1e-2, windows and ``show_pred`` lines equal;
- the CLI writes ``{stem}_r21d.npy`` from the sample video.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_oracles import TorchR2Plus1D, randomize_bn_stats
from video_features_tpu.models import r21d as jr
from video_features_tpu.ops import colorspace as jcs
from video_features_tpu.ops import host_transforms as jht
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch.models import r21d as tr
from video_features_tpu_torch.models.common import cast_floating_
from video_features_tpu_torch.ops import colorspace as tcs
from video_features_tpu_torch.ops import host_transforms as tht
from video_features_tpu_torch.weights.bridge import r21d_state_from_jax

REPO = Path(__file__).resolve().parents[1]
R18, R34 = "r2plus1d_18_16_kinetics", "r2plus1d_34_8_ig65m_ft_kinetics"


def seeded_tree(shapes, seed):
    """A JAX parameter tree of ``shapes`` (``jax.eval_shape`` output) with
    seeded values: LeCun-normal kernels, small biases, batch norms with
    scale, bias, mean and var away from the identity."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["mean"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.normal(size=v.shape) / np.sqrt(fan_in)).astype(
                    np.float32)
            else:
                out[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        return out

    return walk(shapes)


def video_frames(n, seed):
    """Smooth moving gradients plus seeded noise, uint8 RGB 240x320."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    out = []
    for t in range(n):
        frame = np.stack([
            127 + 100 * np.sin(xx / 23 + t / 5),
            127 + 100 * np.sin(yy / 17 - t / 7),
            127 + 100 * np.sin((xx + yy) / 31 + t / 3)], axis=-1)
        frame += rng.normal(0, 8, frame.shape)
        out.append(frame.clip(0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def params():
    return {v: seeded_tree(jax.eval_shape(lambda v=v: jr.init_params(v)),
                           seed)
            for seed, v in enumerate((R18, R34))}


def _port(tree, variant):
    model = tr.R2Plus1D(variant)
    model.load_state_dict(r21d_state_from_jax(tree), strict=True)
    return model.eval()


@pytest.mark.parametrize("variant,shape", [(R18, (2, 8, 32, 32, 3)),
                                           (R34, (1, 8, 32, 32, 3))])
def test_backbone_matches_jax(params, variant, shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jr.R2Plus1D(variant).apply)(
        {"params": params[variant]["backbone"]}, x))
    with torch.inference_mode():
        got = _port(params[variant], variant)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 512)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_classifier_matches_jax(params):
    feats = np.random.default_rng(2).normal(size=(3, 512)).astype(np.float32)
    want = np.asarray(jr.Classifier().apply(
        {"params": params[R18]["head"]}, feats))
    with torch.inference_mode():
        got = _port(params[R18], R18).fc(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (3, 400)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_loads_torch_oracle_strict():
    """torchvision's key layout: the oracle's state dict loads with
    ``strict=True`` and gives the oracle's features."""
    torch.manual_seed(0)
    oracle = TorchR2Plus1D(layers=(2, 2, 2, 2)).eval()
    randomize_bn_stats(oracle)
    port = tr.R2Plus1D(R18)
    port.load_state_dict(oracle.state_dict(), strict=True)
    x = np.random.default_rng(3).normal(size=(1, 8, 32, 32, 3)).astype(
        np.float32)
    with torch.inference_mode():
        want = oracle(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("pair", [(64, 64), (3, 45), (128, 128), (64, 128)])
def test_midplanes_match_jax(pair):
    assert tr.midplanes(*pair) == jr.midplanes(*pair)


def test_bfloat16_closer_to_jax_bfloat16(params):
    x = np.random.default_rng(4).normal(size=(2, 8, 32, 32, 3)).astype(
        np.float32)
    model = jr.R2Plus1D(R18)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda p, v, dt=dt: model.apply(
            {"params": p}, v.astype(dt)).astype(jnp.float32))
        want[dt] = np.asarray(fn(cast_floating(params[R18]["backbone"], dt),
                                 x))
    port = cast_floating_(_port(params[R18], R18), torch.bfloat16)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).bfloat16()).float().numpy()
    jb, jf = want[jnp.bfloat16], want[jnp.float32]
    ours, theirs = np.abs(got - jb), np.abs(jb - jf)
    assert ours.max() < theirs.max() and np.median(ours) < np.median(theirs)


def off_by_one_share(got, want, pixels):
    """Share of the ``pixels * 3`` RGB elements of the frame that the
    elements of ``got`` off ``want`` by exactly 1 amount to (the packed
    I420 planes hold half as many elements, each tie seen through the
    encoder)."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    return float((d > 0).sum() / (pixels * 3))


@pytest.mark.parametrize("ingest", ["float32", "uint8", "yuv420"])
def test_transform_matches_jax_on_bgr(ingest):
    for seed, rgb in enumerate(video_frames(3, 5)):
        got = tht.R21DTransform(ingest)(rgb)
        want = jht.R21DTransform(ingest)(np.ascontiguousarray(rgb[..., ::-1]))
        assert got.shape == want.shape and got.dtype == want.dtype
        if ingest == "float32":
            assert got.shape == (112, 112, 3)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            assert off_by_one_share(got, want, 112 * 112) <= 1e-4, seed


@pytest.mark.parametrize("shape", [(112, 112), (224, 224), (240, 320)])
def test_rgb_to_yuv420_equals_jax(shape):
    """The port encodes in numpy, the JAX package with cv2: byte for
    byte, on random colours and on black, white and saturated corners."""
    rng = np.random.default_rng(shape[0])
    frames = [rng.integers(0, 256, shape + (3,), dtype=np.uint8),
              np.zeros(shape + (3,), np.uint8),
              np.full(shape + (3,), 255, np.uint8),
              (rng.integers(0, 2, shape + (3,)) * 255).astype(np.uint8)]
    for f in frames:
        np.testing.assert_array_equal(tcs.rgb_to_yuv420(f),
                                      jcs.rgb_to_yuv420(f))


def test_yuv420_to_rgb_matches_jax():
    rgb = video_frames(2, 6)
    packed = np.stack([jcs.rgb_to_yuv420(
        jht.R21DTransform("uint8")(f)) for f in rgb])
    want = np.asarray(jcs.yuv420_packed_to_rgb(jnp.asarray(packed), 112, 112))
    got = tcs.yuv420_packed_to_rgb(torch.from_numpy(packed), 112, 112)
    assert tuple(got.shape) == want.shape == (2, 112, 112, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def extractors(tmp_path_factory, sample_video):
    """The JAX and the port's ``ExtractR21D`` on one seeded checkpoint in
    torchvision's key layout (``weights_path``), ``clip_batch_size=3``,
    ``show_pred=true``."""
    from video_features_tpu import config as jconfig
    from video_features_tpu.extractors.r21d import ExtractR21D as JExtract
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.weights.bridge import seeded_init_

    tmp = tmp_path_factory.mktemp("r21d")
    ckpt = tmp / "r21d.pt"
    torch.save(seeded_init_(tr.R2Plus1D(R18), 11).state_dict(), ckpt)
    over = dict(video_paths=sample_video, device="cpu", stack_size=8,
                step_size=8, clip_batch_size=3, show_pred=True,
                weights_path=str(ckpt), output_path=str(tmp / "o"),
                tmp_path=str(tmp / "t"))
    jcfg = jconfig.load_config("r21d", over)
    jconfig.sanity_check(jcfg)
    tcfg = tconfig.load_config("r21d", over)
    tconfig.sanity_check(tcfg)
    yield JExtract(jcfg), ExtractR21D(tcfg)
    ckpt.unlink(missing_ok=True)  # 127 MB, once the module is done


def run_both(extractors, frames, capsys):
    """(JAX features, JAX stdout, port features, port stdout) of ``frames``
    (RGB); the JAX extractor gets them in BGR through its transform."""
    jex, tex = extractors
    jframes = [(jex.host_transform(np.ascontiguousarray(f[..., ::-1])),
                i * 40.0, i) for i, f in enumerate(frames)]
    src = types.SimpleNamespace(frames=lambda: iter(jframes), path="synth")
    capsys.readouterr()
    want = jex._extract_grouped(src)[jex.feature_type]
    jout = capsys.readouterr().out
    got = tex.extract_frames(((f, i * 40.0, i) for i, f in enumerate(frames)),
                             25.0)[tex.feature_type]
    return want, jout, got, capsys.readouterr().out


@pytest.mark.parametrize("n,stack,step,windows", [
    (40, 8, 8, 5), (40, 8, 4, 9), (5, 8, 8, 0)])
def test_extract_frames_matches_jax(extractors, capsys, n, stack, step,
                                    windows):
    for ex in extractors:
        ex.stack_size, ex.step_size = stack, step
    want, jout, got, tout = run_both(extractors, video_frames(n, 7), capsys)
    assert got.shape == want.shape
    assert len(got) == windows
    if windows:
        assert got.shape == (windows, 512)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    lines = [ln for ln in tout.splitlines() if ln.startswith("At frames")]
    assert lines == [f"At frames ({s}, {s + stack})"
                     for s in range(0, step * windows, step)]
    assert tout.splitlines() == jout.splitlines()


def test_cli_writes_outputs(sample_video, tmp_path):
    cmd = [sys.executable, "-m", "video_features_tpu_torch",
           "feature_type=r21d", "device=cpu", "allow_random_weights=true",
           "extraction_fps=4", "on_extraction=save_numpy",
           f"output_path={tmp_path / 'out'}", f"tmp_path={tmp_path / 'tmp'}",
           f"video_paths={sample_video}"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    out = tmp_path / "out" / "r21d" / R18 / \
        f"{Path(sample_video).stem}_r21d.npy"
    feats = np.load(out)
    # ~18.1 s at 4 fps = 72-73 frames -> 4 whole 16-frame stacks
    assert feats.shape == (4, 512) and np.isfinite(feats).all()
