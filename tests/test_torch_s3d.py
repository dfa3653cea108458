"""The port's S3D family against the JAX package's.

Weights: the JAX ``init_params`` tree (its structure and shapes, read with
``jax.eval_shape``; the classifier ``fc`` included) filled with seeded
numpy values and non-trivial batch-norm statistics, carried across by
``s3d_state_from_jax``. Tolerances:

- features and logits at (1, 16, 64, 64, 3) in float32: atol 5e-4, rtol
  5e-4 (the JAX package's torch-oracle bar); a stack that leaves fewer
  than 2 time positions at the head raises, as in JAX;
- the key layout: the JAX ``params_from_torch`` of the port's state dict
  gives the JAX tree's keys and shapes;
- bfloat16: the port closer to JAX bfloat16 than JAX float32 is (at the max
  and the median), features and logits;
- ``S3DTransform`` on 240x320 frames, the port's of an RGB frame against
  JAX's of the same frame in BGR: float32 within 1e-5, uint8 and yuv420
  with at most 0.01% of the frame's elements off by exactly 1 (both resize
  with torch's scale-factor mapping in numpy);
- ``ExtractS3D.extract_frames`` against the JAX extractor on the same 40
  frames (``clip_batch_size=3``): ``stack=step=16`` (2 windows, one ragged
  group), ``stack=16, step=8`` (the materialised path, 4 windows, a ragged
  last group, and ``show_pred``), and a stream too short for one window;
  features within the value tier's atol 1e-2, windows and ``show_pred``
  lines equal;
- ``extraction_fps`` null is forced to 25, and the port's frame plan at
  25 fps on the sample video equals JAX's frame for frame;
- the CLI writes ``{stem}_s3d.npy`` from the sample video.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_r21d import (off_by_one_share, run_both, seeded_tree,
                                   video_frames)
from video_features_tpu.models import s3d as js
from video_features_tpu.ops import host_transforms as jht
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch.models import s3d as ts
from video_features_tpu_torch.models.common import cast_floating_
from video_features_tpu_torch.ops import host_transforms as tht
from video_features_tpu_torch.weights.bridge import s3d_state_from_jax

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return seeded_tree(jax.eval_shape(js.init_params), 21)


def _port(tree):
    model = ts.S3D(400)
    model.load_state_dict(s3d_state_from_jax(tree), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def jax_outputs(params):
    """JAX features and logits at (1, 16, 64, 64, 3), float32 and
    bfloat16, from one jitted call each."""
    x = np.random.default_rng(0).uniform(size=(1, 16, 64, 64, 3)).astype(
        np.float32)
    model = js.S3D(num_classes=400)
    out = {"x": x}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda p, v, dt=dt: tuple(
            model.apply({"params": p}, v.astype(dt),
                        features=f).astype(jnp.float32)
            for f in (True, False)))
        out[jnp.dtype(dt).name] = [np.asarray(a) for a in fn(
            cast_floating(params, dt), x)]
    return out


def test_matches_jax(params, jax_outputs):
    x = torch.from_numpy(jax_outputs["x"])
    model = _port(params)
    with torch.inference_mode():
        got = [model(x, features=f).numpy() for f in (True, False)]
    for g, w, d in zip(got, jax_outputs["float32"], (1024, 400)):
        assert g.shape == w.shape == (1, d)
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4)


def test_head_needs_two_time_positions(params):
    """T = 8 leaves 1 time position at the head (time strides by 8)."""
    with pytest.raises(ValueError, match="stack_size >= 16"):
        _port(params)(torch.zeros(1, 8, 64, 64, 3))
    with pytest.raises(ValueError, match="stack_size >= 16"):
        jax.eval_shape(lambda: js.S3D().apply(
            {"params": params}, jnp.zeros((1, 8, 64, 64, 3))))


def test_key_layout_matches_jax(params):
    back = js.params_from_torch(ts.S3D(400).state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    assert [np.shape(a) for a in jax.tree_util.tree_leaves(back)] == \
        [np.shape(a) for a in jax.tree_util.tree_leaves(params)]


def test_bfloat16_closer_to_jax_bfloat16(params, jax_outputs):
    model = cast_floating_(_port(params), torch.bfloat16)
    x = torch.from_numpy(jax_outputs["x"]).bfloat16()
    with torch.inference_mode():
        got = [model(x, features=f).float().numpy() for f in (True, False)]
    for g, jb, jf in zip(got, jax_outputs["bfloat16"],
                         jax_outputs["float32"]):
        ours, theirs = np.abs(g - jb), np.abs(jb - jf)
        assert ours.max() < theirs.max()
        assert np.median(ours) < np.median(theirs)


@pytest.mark.parametrize("ingest", ["float32", "uint8", "yuv420"])
def test_transform_matches_jax_on_bgr(ingest):
    for rgb in video_frames(3, 8):
        got = tht.S3DTransform(ingest)(rgb)
        want = jht.S3DTransform(ingest)(np.ascontiguousarray(rgb[..., ::-1]))
        assert got.shape == want.shape and got.dtype == want.dtype
        if ingest == "float32":
            assert got.shape == (224, 224, 3)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            assert off_by_one_share(got, want, 224 * 224) <= 1e-4


@pytest.fixture(scope="module")
def extractors(tmp_path_factory, sample_video):
    """The JAX and the port's ``ExtractS3D`` on one seeded checkpoint in
    the reference's key layout (``weights_path``), ``clip_batch_size=3``."""
    from video_features_tpu import config as jconfig
    from video_features_tpu.extractors.s3d import ExtractS3D as JExtract
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.s3d import ExtractS3D
    from video_features_tpu_torch.weights.bridge import seeded_init_

    tmp = tmp_path_factory.mktemp("s3d")
    ckpt = tmp / "s3d.pt"
    torch.save(seeded_init_(ts.S3D(400), 12).state_dict(), ckpt)
    over = dict(video_paths=sample_video, device="cpu", stack_size=16,
                step_size=16, clip_batch_size=3, show_pred=True,
                weights_path=str(ckpt), output_path=str(tmp / "o"),
                tmp_path=str(tmp / "t"))
    out = []
    for cfg_mod, cls in ((jconfig, JExtract), (tconfig, ExtractS3D)):
        cfg = cfg_mod.load_config("s3d", over)
        cfg_mod.sanity_check(cfg)
        out.append(cls(cfg))
    return out


@pytest.mark.parametrize("n,stack,step,windows,show_pred", [
    (40, 16, 16, 2, False), (40, 16, 8, 4, True), (12, 16, 16, 0, False)])
def test_extract_frames_matches_jax(extractors, capsys, n, stack, step,
                                    windows, show_pred):
    for ex in extractors:
        ex.stack_size, ex.step_size, ex.show_pred = stack, step, show_pred
    want, jout, got, tout = run_both(extractors, video_frames(n, 9), capsys)
    assert got.shape == want.shape
    assert len(got) == windows
    if windows:
        assert got.shape == (windows, 1024)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    lines = [ln for ln in tout.splitlines() if ln.startswith("At frames")]
    assert lines == ([f"At frames ({s}, {s + stack})"
                      for s in range(0, step * windows, step)]
                     if show_pred else [])
    assert tout.splitlines() == jout.splitlines()


def test_fps_forced_to_25_and_plan_matches_jax(extractors, sample_video):
    from video_features_tpu.utils.io import VideoSource as JSource
    from video_features_tpu_torch.utils.io import VideoSource

    jex, tex = extractors
    assert tex.extraction_fps == jex.extraction_fps == 25
    got = VideoSource(sample_video, fps=25)
    want = JSource(sample_video, fps=25)
    assert got.fps == want.fps and got.num_frames == want.num_frames
    np.testing.assert_array_equal(got.index_map, want.index_map)
    got_idx = [i for _, _, i in got.frames()]
    assert got_idx == list(range(want.num_frames))


def test_cli_writes_outputs(sample_video, tmp_path):
    cmd = [sys.executable, "-m", "video_features_tpu_torch",
           "feature_type=s3d", "device=cpu", "allow_random_weights=true",
           "stack_size=16", "step_size=16", "extraction_fps=4",
           "on_extraction=save_numpy", f"output_path={tmp_path / 'out'}",
           f"tmp_path={tmp_path / 'tmp'}", f"video_paths={sample_video}"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    feats = np.load(tmp_path / "out" / "s3d" /
                    f"{Path(sample_video).stem}_s3d.npy")
    # ~18.1 s at 4 fps = 72-73 frames -> 4 whole 16-frame stacks
    assert feats.shape == (4, 1024) and np.isfinite(feats).all()
