"""The port's ``raft`` flow family against the JAX package's.

``_batched`` against the JAX ``_batched`` on synthetic frame streams, and
the batched ``VideoSource`` against the JAX one on the sample video, exact.
``ExtractRAFT.extract`` in process on ``tests/assets/v_synth_sample.mp4``
against the JAX ``ExtractRAFT``, both reading one seeded checkpoint in the
reference's key layout through ``weights_path`` and the JAX tree carried
back by the bridge to the same weights: ``precision=float32``, ``resize=host``, ``side_size=32``,
``iters=2``, ``batch_size=2``, ``extraction_fps=2`` (to keep the run short);
the ``raft`` flows within atol 1e-3 px (two recurrent iterations of f32
convs in another summation order), ``fps`` and ``timestamps_ms`` exact. One
CLI run at the YAML defaults (``precision=bfloat16``) writes the three
``.npy`` outputs and skips on a rerun. Each port family's YAML carries
every key of the JAX one at the same default; only the port-only
``video_decode`` key is added.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import yaml

from video_features_tpu.utils import io as jio
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.models import raft as traft
from video_features_tpu_torch.ops import host_transforms as tht
from video_features_tpu_torch.utils import io as tio
from video_features_tpu_torch.weights.bridge import (raft_state_from_jax,
                                                      seeded_init_)

REPO = Path(__file__).resolve().parents[1]
#: keys of the port's YAMLs that the JAX package's do not have
PORT_ONLY_KEYS = {"video_decode"}


@pytest.mark.parametrize("family", ["raft", "i3d", "pwc", "r21d", "s3d",
                                    "resnet", "clip", "vggish"])
def test_yaml_defaults_match_jax(family):
    """Every key of the JAX YAML is in the port's at the same default, and
    the port adds only ``video_decode``; the defaults pass
    ``check_ported``."""
    jax_cfg = yaml.safe_load(
        (REPO / "video_features_tpu" / "configs" / f"{family}.yml").read_text())
    port_cfg = yaml.safe_load((REPO / "video_features_tpu_torch" / "configs"
                               / f"{family}.yml").read_text())
    assert set(jax_cfg) == set(port_cfg) - PORT_ONLY_KEYS
    assert {k: port_cfg[k] for k in jax_cfg} == jax_cfg
    assert port_cfg["precision"] == ("bfloat16" if family in ("raft", "pwc")
                                     else "float32")
    tconfig.check_ported(tconfig.load_config(family))


def _stream(n):
    return ((np.full((2, 2, 3), i, np.uint8), i * 40.0, i) for i in range(n))


@pytest.mark.parametrize("batch_size,overlap", [
    (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (4, 0), (4, 1), (5, 0), (5, 1)])
def test_batched_matches_jax(batch_size, overlap):
    """Full batches, carried-over frames, short tails, and streams whose
    tail is only carried-over frames (never emitted)."""
    for n in range(0, 12):
        got = list(tio._batched(_stream(n), batch_size, overlap))
        want = list(jio._batched(_stream(n), batch_size, overlap))
        assert len(got) == len(want), (n, len(got), len(want))
        for (gb, gt, gi), (wb, wt, wi) in zip(got, want):
            assert (gt, gi) == (wt, wi)
            np.testing.assert_array_equal(np.stack(gb), np.stack(wb))


def test_batched_video_source_matches_jax(sample_video):
    """batch_size + 1 frames with a 1-frame overlap and a host edge resize,
    as the flow families decode."""
    from video_features_tpu.ops import preprocess as jpp

    def jtf(rgb):
        return jpp.pil_resize(rgb, 40, to_smaller_edge=True)

    got = list(tio.VideoSource(sample_video, fps=3, batch_size=4, overlap=1,
                               transform=tht.EdgeResize(40)))
    want = list(jio.VideoSource(sample_video, fps=3, batch_size=4, overlap=1,
                                transform=jtf))
    assert len(got) == len(want) > 3
    for (gb, gt, gi), (wb, wt, wi) in zip(got, want):
        assert (gt, gi) == (wt, wi)
        np.testing.assert_array_equal(np.stack(gb), np.stack(wb))
        assert gb[0].shape == (40, 53, 3)


def _overrides(tmp, sample_video, **over):
    cfg = {"feature_type": "raft", "video_paths": sample_video,
           "device": "cpu", "precision": "float32", "resize": "host",
           "side_size": 32, "iters": 2, "batch_size": 2,
           "extraction_fps": 2, "allow_random_weights": True,
           "on_extraction": "print", "output_path": str(tmp / "out"),
           "tmp_path": str(tmp / "tmp")}
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory, sample_video):
    from video_features_tpu.config import load_config, sanity_check
    from video_features_tpu.extractors.raft import ExtractRAFT as JaxRAFT
    from video_features_tpu_torch.extractors.raft import ExtractRAFT

    tmp = tmp_path_factory.mktemp("raft_family")
    # a checkpoint in the reference's key layout (the port's seeded init),
    # which the JAX package reads through its params_from_torch
    ckpt = tmp / "raft-sintel.pth"
    torch.save(seeded_init_(traft.RAFT(), 11).state_dict(), ckpt)
    over = _overrides(tmp, sample_video, weights_path=str(ckpt))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        jcfg = load_config("raft", over)
        sanity_check(jcfg)
        jex = JaxRAFT(jcfg)
        jfeats = jex.extract(sample_video)
    finally:
        mp.undo()
    tcfg = tconfig.load_config("raft", over)
    tconfig.sanity_check(tcfg)
    tex = ExtractRAFT(tcfg)
    # the JAX tree comes back through the bridge to the same weights
    bridged = raft_state_from_jax(jex.runner.params)
    for key, value in tex.model.state_dict().items():
        assert torch.equal(value, bridged[key]), key
    tex.model.load_state_dict(bridged, strict=True)
    return jfeats, tex.extract(sample_video), tex


def test_family_flow_matches_jax(family_runs):
    jfeats, tfeats, tex = family_runs
    assert tex.resize_mode == "host" and tex.model.iters == 2
    assert tfeats["raft"].dtype == np.float32
    assert tfeats["raft"].shape == jfeats["raft"].shape
    n, two, h, w = tfeats["raft"].shape
    assert (two, h, w) == (2, 32, 42) and n > 10
    np.testing.assert_allclose(tfeats["raft"], jfeats["raft"], atol=1e-3,
                               rtol=0)


def test_family_fps_and_timestamps_match_jax(family_runs):
    jfeats, tfeats, tex = family_runs
    assert float(tfeats["fps"]) == float(jfeats["fps"]) == 2.0
    np.testing.assert_array_equal(tfeats["timestamps_ms"],
                                  jfeats["timestamps_ms"])
    # one timestamp per frame: the overlap duplicates are dropped
    assert len(tfeats["timestamps_ms"]) == len(tfeats["raft"]) + 1
    assert tex.output_feat_keys == ["raft", "fps", "timestamps_ms"]


def test_family_extract_frames_seam(family_runs):
    """extract_frames on synthetic frames: batch_size + 1 frames per batch
    with a 1-frame overlap (an odd count leaves a short last batch), the
    host edge resize, the (N, 2, H, W) layout; a single frame gives no
    flow but its timestamp."""
    tex = family_runs[2]
    rng = np.random.default_rng(1)
    frames = [(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
               i * 50.0, i) for i in range(6)]
    out = tex.extract_frames(iter(frames), 20.0)
    assert out["raft"].shape == (5, 2, 32, 42)
    assert out["timestamps_ms"].tolist() == [i * 50.0 for i in range(6)]
    one = tex.extract_frames(iter(frames[:1]), 20.0)
    assert one["raft"].shape == (0,) and one["timestamps_ms"].tolist() == [0.0]


@pytest.mark.parametrize("key,value,error", [
    ("finetuned_on", "things", NotImplementedError),
    ("iters", 0, ValueError)])
def test_family_rejects_bad_keys(tmp_path, sample_video, key, value, error):
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    cfg = tconfig.load_config("raft", _overrides(tmp_path, sample_video))
    cfg[key] = value
    with pytest.raises(error):
        ExtractRAFT(cfg)


@pytest.mark.parametrize("key,value", [("batch_size", 0), ("batch_size", None),
                                       ("iters", 1.5), ("side_size", -1),
                                       ("resize_to_smaller_edge", "yes"),
                                       ("corr_lookup_impl", "fast")])
def test_sanity_check_validates_raft_keys(tmp_path, sample_video, key, value):
    cfg = tconfig.load_config("raft", _overrides(tmp_path, sample_video))
    tconfig.sanity_check(cfg)  # the defaults and the keys above pass
    bad = tconfig.load_config("raft", dict(
        _overrides(tmp_path, sample_video), **{key: value}))
    with pytest.raises(ValueError):
        tconfig.sanity_check(bad)


def test_family_defaults_and_device(tmp_path, sample_video):
    """The YAML default precision reaches the model; i3d bfloat16 builds
    bfloat16 models (cast I3D weights; PWC on float32 weights, its heads
    float32); device=auto never falls back."""
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    cfg = tconfig.load_config("raft", _overrides(tmp_path, sample_video))
    del cfg["precision"]
    ex = ExtractRAFT(tconfig.load_config("raft", cfg))
    assert ex.precision == "bfloat16" and ex.model.dtype == torch.bfloat16
    assert next(ex.model.parameters()).dtype == torch.bfloat16
    assert ex.model.cnet.norm1.running_var.dtype == torch.bfloat16
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    i3d = ExtractI3D(tconfig.load_config("i3d", {
        "feature_type": "i3d", "precision": "bfloat16", "device": "cpu",
        "allow_random_weights": True}))
    assert i3d.flow_type == "pwc" and i3d.dtype == torch.bfloat16
    for model in (i3d.rgb_model, i3d.flow_stream.i3d):
        assert next(model.parameters()).dtype == torch.bfloat16
        assert model.conv3d_1a_7x7.batch3d.running_var.dtype == \
            torch.bfloat16
    pwc = i3d.flow_stream.pwc
    assert pwc.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pwc.parameters())
    # every family's bfloat16 is ported since vggish's was; another name
    # still raises
    tconfig.check_ported(tconfig.Config(
        {"feature_type": "vggish", "precision": "bfloat16"}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        tconfig.check_ported(tconfig.Config(
            {"feature_type": "nosuch", "precision": "bfloat16"}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            ExtractRAFT(tconfig.load_config("raft", dict(cfg, device="auto")))


def test_cli_raft_defaults_write_outputs(sample_video, tmp_path):
    """``python -m video_features_tpu_torch feature_type=raft`` at the YAML
    defaults (bfloat16), cut to 3 frames, 2 iterations and a 32-pixel
    edge, writes ``{stem}_{raft,fps,timestamps_ms}.npy`` and skips on a
    rerun."""
    cmd = [sys.executable, "-m", "video_features_tpu_torch",
           "feature_type=raft", "device=cpu", "allow_random_weights=true",
           "extraction_total=3", "iters=2", "side_size=32",
           "on_extraction=save_numpy", f"output_path={tmp_path / 'out'}",
           f"tmp_path={tmp_path / 'tmp'}", f"video_paths={sample_video}"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    stem = Path(sample_video).stem
    out = tmp_path / "out" / "raft"
    flow = np.load(out / f"{stem}_raft.npy")
    assert flow.shape == (2, 2, 32, 42) and flow.dtype == np.float32
    assert np.isfinite(flow).all()
    assert np.load(out / f"{stem}_timestamps_ms.npy").shape == (3,)
    assert float(np.load(out / f"{stem}_fps.npy")) > 0
    again = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0 and "skipping" in again.stdout
