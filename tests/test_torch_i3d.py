"""The port's I3D against the JAX package's, with the same weights.

The JAX ``init_params`` tree, with seeded non-trivial batch-norm statistics
so a layout bug in the bridge shows, is carried across; T=18 at 224 (the
case of tests/test_i3d.py) exercises ceil mode in both strided 3D max
pools. Features and logits: atol 5e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import i3d as ji3d
from video_features_tpu_torch.models import i3d as ti3d
from video_features_tpu_torch.weights.bridge import i3d_state_from_jax


def _with_bn_stats(params, seed):
    """Random BN scale/bias/mean/var in every BN of the tree."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = np.asarray(node["mean"]).shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


@pytest.mark.parametrize("modality,in_ch", [("rgb", 3), ("flow", 2)])
def test_i3d_matches_jax(modality, in_ch):
    # jit only makes the flax init compile once instead of op by op
    params = _with_bn_stats(
        jax.jit(ji3d.init_params, static_argnums=0)(modality), seed=in_ch)
    model = ti3d.I3D(400, in_channels=in_ch)
    model.load_state_dict(i3d_state_from_jax(params), strict=True)
    model.eval()
    x = np.random.default_rng(1).uniform(
        -1, 1, size=(1, 18, 224, 224, in_ch)).astype(np.float32)
    jm = ji3d.I3D(num_classes=400)
    want_f, want_l = map(np.asarray, jax.jit(lambda p, v: (
        jm.apply({"params": p}, v, features=True),
        jm.apply({"params": p}, v, features=False)))(params, jnp.asarray(x)))
    with torch.inference_mode():
        got_f = model(torch.from_numpy(x), features=True).numpy()
        got_l = model(torch.from_numpy(x), features=False).numpy()
    assert got_f.shape == want_f.shape == (1, 1024)
    assert got_l.shape == want_l.shape == (1, 400)
    np.testing.assert_allclose(got_f, want_f, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got_l, want_l, atol=5e-4, rtol=0)


@pytest.mark.parametrize("kernel,stride", [
    ((7, 7, 7), (2, 2, 2)), ((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)),
    ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (2, 2, 2)), ((1, 1, 1), (1, 1, 1))])
def test_tf_same_pads_match_jax(kernel, stride):
    assert ti3d.tf_same_pads(kernel, stride) == \
        ji3d.tf_same_pads(kernel, stride)


@pytest.mark.parametrize("window,strides,shape", [
    ((1, 3, 3), (1, 2, 2), (1, 5, 9, 8, 3)),
    ((3, 3, 3), (2, 2, 2), (2, 9, 7, 6, 4)),
    ((2, 2, 2), (2, 2, 2), (1, 5, 5, 3, 2)),
    ((3, 3, 3), (1, 1, 1), (1, 4, 4, 4, 2))])
def test_max_pool_tf_ceil_matches_jax(window, strides, shape):
    """Zero padding takes part in the max; the ceil-mode overhang never
    wins (inputs are negative so a wrong rule shows)."""
    x = -np.random.default_rng(0).uniform(0.1, 1, size=shape).astype(
        np.float32)
    want = np.asarray(ji3d.max_pool_tf_ceil(jnp.asarray(x), window, strides))
    got = ti3d.max_pool_tf_ceil(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                window, strides).permute(0, 2, 3, 4, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_head_rejects_short_stacks():
    with pytest.raises(ValueError, match="stack_size >= 10"):
        ti3d.I3D(400)(torch.zeros(1, 8, 224, 224, 3))
