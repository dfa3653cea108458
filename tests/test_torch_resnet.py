"""The port's ResNet family against the JAX package's.

Weights: the JAX ``init_params`` tree (its structure and shapes, read with
``jax.eval_shape``) filled with seeded numpy values, batch norms with
non-trivial statistics, carried across by ``resnet_state_from_jax``.
Tolerances:

- the backbone (resnet18 at (2, 64, 64, 3), resnet50 at (1, 64, 96, 3)) and
  the ImageNet ``fc`` logits in float32: rtol 1e-4, atol 1e-5 times the
  largest magnitude of the JAX output; the port also loads
  tests/torch_oracles.py ``TorchResNet``'s state dict with ``strict=True``
  and matches it at the same bar;
- bfloat16: the port closer to JAX bfloat16 than JAX float32 is (at the max
  and the median);
- the bridge round-trips: JAX tree -> port state dict -> JAX
  ``params_from_torch`` gives every leaf back exactly;
- ``ExtractResNet`` (resnet18, one seeded checkpoint in torchvision's key
  layout read by both packages through ``weights_path``) on the sample
  video with ``extraction_total=4``, ``resize=host|device`` x
  ``ingest=uint8|yuv420``: features within the value tier's atol 1e-2,
  ``fps`` and ``timestamps_ms`` exact; ``show_pred`` prints JAX's lines;
- the CLI writes the JAX CLI's ``.npy`` files, by name and shape.
"""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_r21d import seeded_tree
from tests.torch_oracles import TorchResNet, randomize_bn_stats
from video_features_tpu.models import resnet as jr
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch.models import resnet as tr
from video_features_tpu_torch.models.common import cast_floating_
from video_features_tpu_torch.weights.bridge import (resnet_state_from_jax,
                                                      seeded_init_)

VARIANTS = ("resnet18", "resnet50")


def assert_close_to_scale(got, want, rtol=1e-4, atol=1e-5):
    """rtol, and atol relative to the largest magnitude of ``want``."""
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def params():
    return {v: seeded_tree(jax.eval_shape(lambda v=v: jr.init_params(v)),
                           seed)
            for seed, v in enumerate(VARIANTS)}


def _port(tree, variant):
    model = tr.ResNet(variant)
    model.load_state_dict(resnet_state_from_jax(tree), strict=True)
    return model.eval()


@pytest.mark.parametrize("variant,shape", [("resnet18", (2, 64, 64, 3)),
                                           ("resnet50", (1, 64, 96, 3))])
def test_backbone_matches_jax(params, variant, shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jr.ResNet(variant).apply)(
        {"params": params[variant]["backbone"]}, x))
    with torch.inference_mode():
        got = _port(params[variant], variant)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], tr.FEATURE_DIMS[variant])
    assert_close_to_scale(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_classifier_matches_jax(params, variant):
    feats = np.random.default_rng(2).normal(
        size=(3, tr.FEATURE_DIMS[variant])).astype(np.float32)
    want = np.asarray(jr.Classifier().apply(
        {"params": params[variant]["head"]}, feats))
    with torch.inference_mode():
        got = _port(params[variant], variant).fc(
            torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (3, 1000)
    assert_close_to_scale(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_round_trips(params, variant):
    back = jr.params_from_torch(resnet_state_from_jax(params[variant]))
    want = jax.tree_util.tree_flatten_with_path(params[variant])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("variant", VARIANTS)
def test_loads_torch_oracle_strict(variant):
    """torchvision's key layout: the oracle's state dict loads with
    ``strict=True`` and gives the oracle's features."""
    torch.manual_seed(0)
    oracle = TorchResNet(variant).eval()
    randomize_bn_stats(oracle)
    port = tr.ResNet(variant)
    port.load_state_dict(oracle.state_dict(), strict=True)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    with torch.inference_mode():
        want = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert_close_to_scale(got, want)


def test_bfloat16_closer_to_jax_bfloat16(params):
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    model = jr.ResNet("resnet18")
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda p, v, dt=dt: model.apply(
            {"params": p}, v.astype(dt)).astype(jnp.float32))
        want[dt] = np.asarray(fn(cast_floating(
            params["resnet18"]["backbone"], dt), x))
    port = cast_floating_(_port(params["resnet18"], "resnet18"),
                          torch.bfloat16)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).bfloat16()).float().numpy()
    jb, jf = want[jnp.bfloat16], want[jnp.float32]
    ours, theirs = np.abs(got - jb), np.abs(jb - jf)
    assert ours.max() < theirs.max() and np.median(ours) < np.median(theirs)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("resnet") / "resnet18.pt"
    torch.save(seeded_init_(tr.ResNet("resnet18"), 11).state_dict(), path)
    return path


def _extractors(tmp, sample_video, checkpoint, **over):
    from video_features_tpu import config as jconfig
    from video_features_tpu.extractors.resnet import ExtractResNet as JEx
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.resnet import ExtractResNet

    cfg = dict(video_paths=sample_video, device="cpu", model_name="resnet18",
               batch_size=3, extraction_total=4, weights_path=str(checkpoint),
               output_path=str(tmp / "o"), tmp_path=str(tmp / "t"))
    cfg.update(over)
    jcfg = jconfig.load_config("resnet", cfg)
    jconfig.sanity_check(jcfg)
    tcfg = tconfig.load_config("resnet", cfg)
    tconfig.sanity_check(tcfg)
    return JEx(jcfg), ExtractResNet(tcfg)


@pytest.mark.parametrize("resize", ["host", "device"])
@pytest.mark.parametrize("ingest", ["uint8", "yuv420"])
def test_extract_matches_jax(tmp_path, sample_video, checkpoint, resize,
                             ingest):
    jex, tex = _extractors(tmp_path, sample_video, checkpoint,
                           resize=resize, ingest=ingest)
    assert tex.resize_mode == jex.resize_mode == resize
    want, got = jex.extract(sample_video), tex.extract(sample_video)
    assert set(got) == set(want) == {"resnet", "fps", "timestamps_ms"}
    assert got["resnet"].shape == want["resnet"].shape == (4, 512)
    np.testing.assert_allclose(got["resnet"], want["resnet"], atol=1e-2,
                               rtol=0)
    assert got["fps"] == want["fps"]
    np.testing.assert_array_equal(got["timestamps_ms"],
                                  want["timestamps_ms"])


def test_show_pred_prints_jax_lines(tmp_path, sample_video, checkpoint):
    """ImageNet top-5 tables per frame; the logits printed to 3 decimals
    may differ in the last digit, so the labels are held equal."""
    jex, tex = _extractors(tmp_path, sample_video, checkpoint,
                           show_pred=True, extraction_total=2)
    assert tex.resize_mode == "host"  # auto resolves to host for show_pred
    out = {}
    for name, ex in (("jax", jex), ("port", tex)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ex.extract(sample_video)
        out[name] = [ln.split("|")[-1] for ln in buf.getvalue().splitlines()]
    assert out["port"] == out["jax"]
    assert sum("Label" in ln for ln in out["port"]) == 2


def test_cli_writes_jax_outputs(tmp_path, sample_video, checkpoint):
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain

    files = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        root = tmp_path / name
        with contextlib.redirect_stdout(io.StringIO()):
            main(["feature_type=resnet", "model_name=resnet18",
                  "device=cpu", "extraction_total=3", "batch_size=2",
                  f"weights_path={checkpoint}", "on_extraction=save_numpy",
                  f"output_path={root}", f"tmp_path={tmp_path / 't'}",
                  f"video_paths={sample_video}"])
        files[name] = {str(p.relative_to(root)): np.load(p).shape
                       for p in sorted(root.rglob("*.npy"))}
    stem = Path(sample_video).stem
    assert files["port"] == files["jax"] == {
        f"resnet/resnet18/{stem}_resnet.npy": (3, 512),
        f"resnet/resnet18/{stem}_fps.npy": (),
        f"resnet/resnet18/{stem}_timestamps_ms.npy": (3,)}
