"""The port's parameter bridge against the JAX package's ``params_from_torch``.

A state dict in the reference's torch key layout goes through the JAX
``params_from_torch`` and back through the port's bridge and must come back
tensor for tensor; a JAX tree goes the other way round and must come back
array for array; and the port's modules carry the reference's key layout,
so such a state dict loads with ``strict=True``. PWC's transposed
convolutions, stored flipped in the JAX tree, invert exactly and compute
the same function on both sides.
"""
import numpy as np
import pytest
import torch

from video_features_tpu.models import i3d as ji3d
from video_features_tpu.models import pwc as jpwc
from video_features_tpu.models import raft as jraft
from video_features_tpu_torch.models import i3d as ti3d
from video_features_tpu_torch.models import pwc as tpwc
from video_features_tpu_torch.models import raft as traft
from video_features_tpu_torch.weights import bridge

#: keys as the reference checkpoints spell them (raft-sintel.pth,
#: i3d_rgb.pt, pwc_net_sintel.pt), with the shapes those modules have
REFERENCE_KEYS = {
    "raft": {
        "fnet.conv1.weight": (64, 3, 7, 7),
        "fnet.layer2.0.downsample.0.weight": (96, 64, 1, 1),
        "cnet.norm1.running_mean": (64,),
        "cnet.layer2.0.norm3.running_var": (96,),
        "cnet.layer2.0.downsample.1.running_var": (96,),
        "cnet.layer3.1.norm2.num_batches_tracked": (),
        "update_block.encoder.convc1.weight": (256, 324, 1, 1),
        "update_block.gru.convq2.weight": (128, 384, 5, 1),
        "update_block.flow_head.conv2.bias": (2,),
        "update_block.mask.2.weight": (576, 256, 1, 1),
    },
    "i3d": {
        "conv3d_1a_7x7.conv3d.weight": (64, 3, 7, 7, 7),
        "conv3d_1a_7x7.batch3d.running_mean": (64,),
        "mixed_3b.branch_1.1.conv3d.weight": (128, 96, 3, 3, 3),
        "mixed_3b.branch_3.1.batch3d.weight": (32,),
        "mixed_5c.branch_0.conv3d.weight": (384, 832, 1, 1, 1),
        "conv3d_0c_1x1.conv3d.bias": (400,),
    },
    "pwc": {
        "moduleExtractor.moduleOne.0.weight": (16, 3, 3, 3),
        "moduleExtractor.moduleSix.4.bias": (196,),
        "moduleSix.moduleOne.0.weight": (128, 81, 3, 3),
        "moduleSix.moduleSix.0.weight": (2, 529, 3, 3),
        "moduleFiv.moduleUpflow.weight": (2, 2, 4, 4),
        "moduleFiv.moduleUpfeat.weight": (529, 2, 4, 4),
        "moduleTwo.moduleUpfeat.weight": (597, 2, 4, 4),
        "moduleTwo.moduleFiv.0.weight": (32, 533, 3, 3),
        "moduleRefiner.moduleMain.0.weight": (128, 565, 3, 3),
        "moduleRefiner.moduleMain.12.bias": (2,),
    },
}
#: each family's JAX converter and the port's bridge back
CONVERTERS = {"raft": (jraft.params_from_torch, bridge.raft_state_from_jax),
              "i3d": (ji3d.params_from_torch, bridge.i3d_state_from_jax),
              "pwc": (jpwc.params_from_torch, bridge.pwc_state_from_jax)}


def _model(name):
    return {"raft": lambda: traft.RAFT(iters=1), "i3d": lambda: ti3d.I3D(400),
            "pwc": tpwc.PWCNet}[name]()


def _torch_layout_state(name, seed=3):
    """A reference-layout state dict with random values everywhere,
    batch-norm statistics included."""
    m = bridge.seeded_init_(_model(name), seed)
    gen = torch.Generator().manual_seed(seed)
    sd = m.state_dict()
    for k, v in sd.items():
        if v.dtype.is_floating_point and v.dim() == 1:
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    return sd


@pytest.mark.parametrize("name", ["raft", "i3d", "pwc"])
def test_port_modules_carry_reference_keys(name):
    sd = _model(name).state_dict()
    for key, shape in REFERENCE_KEYS[name].items():
        assert tuple(sd[key].shape) == shape, key


@pytest.mark.parametrize("name", ["raft", "i3d", "pwc"])
def test_torch_state_round_trips_through_jax(name):
    sd = _torch_layout_state(name)
    to_jax, from_jax = CONVERTERS[name]
    back = from_jax(to_jax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    fresh = _model(name)
    fresh.load_state_dict(back, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("name", ["raft", "i3d", "pwc"])
def test_jax_tree_round_trips_through_torch(name):
    """JAX-layout tree (HWIO/DHWIO kernels, scale/mean/var, PWC's flipped
    transposed-conv kernels) -> bridge -> the JAX converter gives the same
    tree back."""
    sd = _torch_layout_state(name, seed=7)
    to_jax, from_jax = CONVERTERS[name]
    tree = to_jax(sd)
    again = to_jax(from_jax(tree))

    def flat(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{p}/{k}") if isinstance(v, dict)
                       else {f"{p}/{k}": np.asarray(v)})
        return out

    a, b = flat(tree), flat(again)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_convc1_rows_stay_in_lookup_order():
    """The JAX (1, 1, 324, 256) convc1 kernel becomes the port's
    (256, 324, 1, 1) conv and, transposed back, the kernel's (324, 256)
    weight row for row."""
    rng = np.random.default_rng(0)
    k = rng.normal(size=(1, 1, 324, 256)).astype(np.float32)
    tree = {"update_block": {"encoder": {"convc1": {
        "kernel": k, "bias": np.zeros(256, np.float32)}}}}
    sd = bridge.raft_state_from_jax(tree)
    enc = traft.BasicMotionEncoder()
    enc.convc1.weight.data.copy_(sd["update_block.encoder.convc1.weight"])
    w, _ = enc.convc1_matrix()
    np.testing.assert_array_equal(w.detach().numpy(), k[0, 0])


@pytest.mark.parametrize("name,c_in", [("moduleUpflow", 2),
                                        ("moduleUpfeat", 529)])
def test_pwc_transposed_conv_inverts_exactly(name, c_in):
    """A flipped HWIO kernel of the JAX tree comes back as the IOHW weight
    it was built from, element for element, and both compute the same
    ConvTranspose2d(k=4, stride=2, pad=1) on one input (a kernel left
    unflipped or transposed the generic way would not)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(c_in)
    w = rng.normal(size=(c_in, 2, 4, 4)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    tree = jpwc.params_from_torch({
        f"moduleFiv.{name}.weight": torch.from_numpy(w),
        f"moduleFiv.{name}.bias": torch.from_numpy(b)})
    kernel = tree["moduleFiv"][f"{name}_kernel"]
    assert kernel.shape == (4, 4, c_in, 2)
    sd = bridge.pwc_state_from_jax(tree)
    np.testing.assert_array_equal(sd[f"moduleFiv.{name}.weight"].numpy(), w)
    np.testing.assert_array_equal(sd[f"moduleFiv.{name}.bias"].numpy(), b)
    x = rng.normal(size=(1, 5, 6, c_in)).astype(np.float32)
    want = np.asarray(jpwc.conv_transpose_4s2p1(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(b)))
    up = tpwc.Decoder(5).moduleUpflow if c_in == 2 else \
        tpwc.Decoder(5).moduleUpfeat
    up.load_state_dict({"weight": sd[f"moduleFiv.{name}.weight"],
                        "bias": sd[f"moduleFiv.{name}.bias"]})
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 10, 12, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_seeded_init_is_deterministic():
    a = bridge.seeded_init_(ti3d.I3D(400, in_channels=2), 5).state_dict()
    b = bridge.seeded_init_(ti3d.I3D(400, in_channels=2), 5).state_dict()
    c = bridge.seeded_init_(ti3d.I3D(400, in_channels=2), 6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    key = "conv3d_1a_7x7.conv3d.weight"
    assert not torch.equal(a[key], c[key])
    assert float(a[key].std()) == pytest.approx(1 / np.sqrt(2 * 343),
                                                rel=0.05)
    assert torch.equal(a["mixed_3b.branch_0.batch3d.running_var"],
                       torch.ones(64))


def test_checkpoint_file_loads_strict(tmp_path, monkeypatch):
    """A checkpoint file in the reference's layout (DataParallel 'module.'
    prefix, wrapped in a 'state_dict' container) loads into the port
    through the weights store; no file (an empty ``VFT_WEIGHTS_DIR``) and
    no allow_random_weights is an error, not random weights."""
    from video_features_tpu_torch.weights.store import resolve_params
    monkeypatch.setenv("VFT_WEIGHTS_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch"))
    sd = _torch_layout_state("i3d", seed=11)
    path = tmp_path / "i3d_flow.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    m = resolve_params(ti3d.I3D(400), "i3d_rgb", str(path),
                       allow_random=False, seed=0)
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        resolve_params(ti3d.I3D(400), "i3d_rgb", None, allow_random=False,
                       seed=0)
