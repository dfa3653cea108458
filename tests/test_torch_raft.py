"""The port's RAFT against the JAX package's, with the same weights.

The JAX ``init_params(iters=4)`` tree is carried across with the port's
bridge; the same numpy-seeded inputs go through both. Tolerances: flow
atol 1e-3 px, rtol 1e-4 (four recurrent iterations of f32 convs in another
summation order); pyramid levels 1e-5; pad amounts exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import raft as jraft
from video_features_tpu_torch.models import raft as traft
from video_features_tpu_torch.weights.bridge import raft_state_from_jax


@pytest.fixture(scope="module")
def pair_and_flow():
    """Shared weights, a (2, 64, 96) pair batch and the JAX flow."""
    # jit only makes the flax init compile once instead of op by op
    params = jax.jit(jraft.init_params, static_argnums=0)(4)
    rng = np.random.default_rng(2)
    x1 = rng.integers(0, 255, size=(2, 64, 96, 3)).astype(np.float32)
    x2 = rng.integers(0, 255, size=(2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jraft.RAFT(iters=4).apply(
        {"params": params}, jnp.asarray(x1), jnp.asarray(x2)))
    model = traft.RAFT(iters=4)
    model.load_state_dict(raft_state_from_jax(params), strict=True)
    return model.eval(), x1, x2, want, params


@pytest.mark.parametrize("impl,fuse", [(None, None), ("pallas", False),
                                       ("gather", None), ("onehot", None)])
def test_flow_matches_jax(pair_and_flow, impl, fuse):
    """Every lookup path (on the CPU the kernel paths run the wrappers'
    plain versions) gives the JAX flow."""
    model, x1, x2, want, _ = pair_and_flow
    model.corr_lookup_impl = impl
    model.fuse_convc1 = True if fuse is None else fuse
    with torch.inference_mode():
        got = model(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    assert got.shape == want.shape == (2, 64, 96, 2)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


def test_padded_flow_matches_jax(pair_and_flow):
    """Edge padding to /8 (sintel mode) at an odd size, through the model."""
    model, x1, x2, _, params = pair_and_flow
    pairs = np.stack([x1[:, :61, :90], x2[:, :61, :90]], axis=1)
    want, want_pad = jraft.padded_flow(jraft.RAFT(iters=4), params,
                                       jnp.asarray(pairs))
    model.corr_lookup_impl, model.fuse_convc1 = None, True
    with torch.inference_mode():
        got, got_pad = traft.padded_flow(model, torch.from_numpy(pairs))
    assert got_pad == want_pad == ((1, 2), (3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 436, 1024, 3), (1, 48, 64, 3),
                                   (2, 256, 341, 3), (1, 61, 90, 3),
                                   (3, 7, 9, 3)])
@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_pad_to_multiple_amounts_exact(shape, mode):
    x = np.zeros(shape, dtype=np.uint8)
    assert traft.pad_to_multiple(x, mode=mode) == \
        jraft.pad_to_multiple(x, mode=mode)


def test_encoders_norms_and_upsample_match_jax():
    """instance_norm and convex_upsample against the JAX functions."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32) * 3 + 1
    got = traft.instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jraft.instance_norm(jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    flow = rng.normal(size=(2, 4, 6, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 4, 6, 576)).astype(np.float32)
    got = traft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    want = jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    assert tuple(got.shape) == want.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_packed_lookup_is_not_ported():
    with pytest.raises(NotImplementedError, match="_packed_kernel"):
        traft.RAFT(iters=1, corr_lookup_impl="packed")
