"""The port's RAFT against the JAX package's, with the same weights.

The JAX ``init_params(iters=4)`` tree is carried across with the port's
bridge; the same numpy-seeded inputs go through both. Tolerances: flow
atol 1e-3 px, rtol 1e-4 (four recurrent iterations of f32 convs in another
summation order); pyramid levels 1e-5; pad amounts exact.

bfloat16 mode, at a tiny size (1 pair of 32x48, 2 iterations; JAX bfloat16
on the CPU is slow): the port's ``RAFT(dtype=bfloat16)`` with weights cast
by ``cast_floating_`` against the JAX ``RAFT(dtype=bfloat16)`` on
``cast_floating`` params. bfloat16 rounds at other places in the two
frameworks, so the bar is relative: the port's bfloat16 flow must be closer
to the JAX bfloat16 flow than the JAX float32 flow is (max and median abs
difference), and within the JAX package's own bfloat16 bound against the
float32 flow (median < 0.1 px, p99 < 1.0 px, tests/test_raft.py). ``BNInf``
in bfloat16 is held bit for bit against the JAX ``BNInf`` (in float32 to
1e-5: the two float32 rsqrts can differ in the last bit); the cast weights
value for value against the JAX ``cast_floating`` tree.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import common as jcommon
from video_features_tpu.models import raft as jraft
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch.models import common as tcommon
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
                                       ("gather", None), ("onehot", None),
                                       ("packed", None)])
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


@pytest.fixture(scope="module")
def bf16_flows(pair_and_flow):
    """One 32x48 pair, 2 iterations: the JAX float32 and bfloat16 flows
    (jitted: op by op, JAX bfloat16 on the CPU takes far longer)."""
    params = pair_and_flow[4]
    rng = np.random.default_rng(6)
    x1 = rng.integers(0, 255, size=(1, 32, 48, 3)).astype(np.float32)
    x2 = rng.integers(0, 255, size=(1, 32, 48, 3)).astype(np.float32)

    def run(dtype, p):
        fn = jax.jit(lambda p, a, b: jraft.RAFT(iters=2, dtype=dtype).apply(
            {"params": p}, a, b))
        return np.asarray(fn(p, jnp.asarray(x1), jnp.asarray(x2)))

    f32 = run(jnp.float32, params)
    bf16 = run(jnp.bfloat16, cast_floating(params, jnp.bfloat16))
    return params, x1, x2, f32, bf16


@pytest.mark.parametrize("impl", [None, "gather", "packed"])
def test_bfloat16_flow_matches_jax(bf16_flows, impl):
    params, x1, x2, f32, bf16 = bf16_flows
    model = traft.RAFT(iters=2, corr_lookup_impl=impl, dtype=torch.bfloat16)
    model.load_state_dict(raft_state_from_jax(params), strict=True)
    tcommon.cast_floating_(model, torch.bfloat16).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 32, 48, 2)
    got = got.numpy()
    assert np.isfinite(got).all()
    port, jax_f32 = np.abs(got - bf16), np.abs(f32 - bf16)
    assert port.max() < jax_f32.max(), (port.max(), jax_f32.max())
    assert np.median(port) < np.median(jax_f32), \
        (np.median(port), np.median(jax_f32))
    drift = np.abs(got - f32)
    assert np.median(drift) < 0.1 and np.percentile(drift, 99) < 1.0


def test_cast_floating_matches_jax(pair_and_flow):
    """Every floating parameter and buffer (batch-norm statistics too) is
    cast, as the JAX tree's are; num_batches_tracked stays an int."""
    params = pair_and_flow[4]
    model = traft.RAFT(iters=1)
    model.load_state_dict(raft_state_from_jax(params), strict=True)
    tcommon.cast_floating_(model, torch.bfloat16)
    want = raft_state_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, dtype=np.float32),
        cast_floating(params, jnp.bfloat16)))
    state = model.state_dict()
    assert state["cnet.norm1.running_var"].dtype == torch.bfloat16
    assert state["cnet.norm1.num_batches_tracked"].dtype == torch.long
    for key, value in state.items():
        if value.is_floating_point():
            assert value.dtype == torch.bfloat16, key
            assert torch.equal(value.float(), want[key]), key


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bninf_matches_jax(dtype):
    """BNInf: bit for bit in bfloat16 (rsqrt of var + eps in float32, the
    rest in bfloat16); in float32 within 1e-5 (XLA's and torch's float32
    rsqrt can differ in the last bit)."""
    rng = np.random.default_rng(8)
    c = 64
    x = rng.normal(size=(2, 5, 7, c)).astype(np.float32) * 3
    p = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(size=c),
         "mean": rng.normal(size=c), "var": rng.uniform(0.5, 1.5, c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    want = jcommon.BNInf().apply(
        {"params": cast_floating({k: jnp.asarray(v) for k, v in p.items()},
                                 jdt)}, jnp.asarray(x).astype(jdt))
    bn = tcommon.BNInf(c)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(p[key]))
    tdt = getattr(torch, dtype)
    tcommon.cast_floating_(bn, tdt)
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt))
    assert got.dtype == tdt
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
