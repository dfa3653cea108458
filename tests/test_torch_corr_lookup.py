"""The port's correlation lookup against the JAX package's.

On the CPU the port's kernel wrappers run their plain versions (the CUDA
kernels need a card), so these tests hold those plain versions against the
JAX Pallas kernels in interpret mode and the JAX plain lookups, on the same
numpy-seeded pyramids and coords. Tolerances: the level and packed lookups
1e-5 (f32 rounding of the bilinear weights), the fused projection 1e-4 (its
324-term sum runs in another order); the packed plane and its geometry are
compared exactly (byte for byte). The packed lookup also runs on two cases
of its own: a level wider than 128 (``j = 1``, ``k = 256``) and a pyramid
with 17 row groups, which the JAX kernel's VMEM gate refuses (there it is
held against the JAX gather only). The card-only test holds each CUDA
kernel against its plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.kernels import corr_lookup as jcl
from video_features_tpu.models import raft as jraft
from video_features_tpu_torch.device import set_precision
from video_features_tpu_torch.kernels import build
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.models import raft as traft


def _case(name):
    """(pyramid levels (B, P, Hl, Wl) np, coords (B, H, W, 2) np) for the
    cases of tests/test_kernels.py: random coords spread slightly past the
    plane, integer coords, whole windows out of the plane, odd level sizes
    and a pyramid that pools down to 1x1 and 0x0."""
    rng = np.random.default_rng({"random": 0, "integer": 1, "outside": 2,
                                 "odd": 3, "degenerate": 4, "wide": 5,
                                 "groups17": 6}[name])
    b, h8, w8, c = {"odd": (2, 13, 11, 32), "degenerate": (1, 6, 5, 16),
                    "wide": (1, 3, 130, 16), "groups17": (1, 34, 43, 8)
                    }.get(name, (1, 12, 10, 64))
    f1 = rng.normal(size=(b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h8, w8, c)).astype(np.float32)
    if name in PACKED_CASES[len(CASES):]:
        # correlations of about 1: the packed and the gather formulations
        # round the bilinear weights at different magnitudes (floor(c/2^l
        # - r) + d against floor(c/2^l + d)), a few 1e-6 relative
        f1 *= 0.25
    pyramid = [np.array(p) for p in jraft.build_corr_pyramid(
        jnp.asarray(f1), jnp.asarray(f2))]
    if name in ("integer", "outside"):
        gx, gy = np.meshgrid(np.arange(w8, dtype=np.float32),
                             np.arange(h8, dtype=np.float32))
        coords = np.broadcast_to(np.stack([gx, gy], -1),
                                 (b, h8, w8, 2)).copy()
        if name == "outside":
            coords[:, 0] = -50.0
            coords[:, 1, :, 0] = w8 + 40.0
    else:
        coords = rng.uniform(-6.0, max(h8, w8) + 6.0,
                             size=(b, h8, w8, 2)).astype(np.float32)
    return pyramid, coords


CASES = ["random", "integer", "outside", "odd", "degenerate"]
#: the packed layout's own edge cases: a level wider than 128 lanes, and
#: 17 row groups at level 0 (past the JAX kernel's G <= 16 gate)
PACKED_CASES = CASES + ["wide", "groups17"]


def _torch(pyramid, coords):
    return [torch.from_numpy(p) for p in pyramid], torch.from_numpy(coords)


def test_degenerate_case_pools_to_empty_levels():
    pyramid, _ = _case("degenerate")
    shapes = [p.shape[2:] for p in pyramid]
    assert (1, 1) in shapes and (0, 0) in shapes, shapes


@pytest.mark.parametrize("name", CASES)
def test_level_lookup_matches_jax(name):
    pyramid, coords = _case(name)
    tp, tc = _torch(pyramid, coords)
    got = tcl.corr_lookup_level_cuda(tp, tc).numpy()
    jp, jc = [jnp.asarray(p) for p in pyramid], jnp.asarray(coords)
    gather = np.asarray(jraft.corr_lookup_gather(jp, jc))
    assert got.shape == gather.shape == coords.shape[:3] + (324,)
    np.testing.assert_allclose(got, gather, atol=1e-5, rtol=0)
    if name != "degenerate":  # the JAX kernel gates 0x0 levels out itself
        pallas = np.asarray(jcl.corr_lookup_pallas(jp, jc, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    if name == "outside":  # whole windows outside every level: exact zeros
        assert np.all(got[:, 0] == 0.0)


@pytest.mark.parametrize("name", CASES)
def test_onehot_lookup_matches_jax(name):
    pyramid, coords = _case(name)
    got = tcl.corr_lookup_onehot_ref(*_torch(pyramid, coords)).numpy()
    want = np.asarray(jcl.corr_lookup_onehot(
        [jnp.asarray(p) for p in pyramid], jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_proj_lookup_matches_jax(name):
    pyramid, coords = _case(name)
    rng = np.random.default_rng(9)
    weight = (rng.normal(size=(324, 24)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(24,)).astype(np.float32)
    tp, tc = _torch(pyramid, coords)
    got = tcl.corr_lookup_proj_cuda(tp, tc, torch.from_numpy(weight),
                                    torch.from_numpy(bias)).numpy()
    jp, jc = [jnp.asarray(p) for p in pyramid], jnp.asarray(coords)
    ref = np.asarray(jcl.corr_lookup_proj_ref(jp, jc, jnp.asarray(weight),
                                              jnp.asarray(bias)))
    stacked, metas = jcl.stack_aligned_pyramid(jp)
    kernel = np.asarray(jcl.corr_lookup_proj(
        stacked, metas, jc, jnp.asarray(weight), jnp.asarray(bias),
        interpret=True))
    assert got.shape == ref.shape == coords.shape[:3] + (24,)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, kernel, atol=1e-4, rtol=0)
    if name == "outside":  # zeros rule: relu(bias) exactly
        np.testing.assert_array_equal(
            got[:, 0], np.broadcast_to(np.maximum(bias, 0), got[:, 0].shape))


@pytest.mark.parametrize("hl,wl", [(0, 0), (1, 1), (3, 5), (30, 40),
                                   (32, 43), (34, 43), (4, 128), (3, 130),
                                   (2, 300), (7, 129)])
def test_packing_plan_matches_jax(hl, wl):
    assert tuple(tcl.plan_level(hl, wl)) == tuple(jcl._plan_level(hl, wl))


def test_packing_plan_of_the_main_paths():
    """The i3d stack's level 0 (grid 32x43) packs 2 rows per group in 16
    groups; a level wider than 128 packs one row per 256-lane group."""
    assert tcl.plan_level(32, 43)[2:5] == (2, 16, 128)
    assert tcl.plan_level(3, 130)[2:5] == (1, 3, 256)


@pytest.mark.parametrize("name", PACKED_CASES)
def test_pack_pyramid_matches_jax_bytes(name):
    pyramid, _ = _case(name)
    want, want_metas = jcl.pack_pyramid([jnp.asarray(p) for p in pyramid])
    got, got_metas = tcl.pack_pyramid([torch.from_numpy(p) for p in pyramid])
    assert [tuple(m) for m in got_metas] == [tuple(m) for m in want_metas]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("name", PACKED_CASES)
def test_packed_lookup_matches_jax(name):
    pyramid, coords = _case(name)
    tp, tc = _torch(pyramid, coords)
    packed, metas = tcl.pack_pyramid(tp)
    got = tcl.corr_lookup_packed_cuda(packed, metas, tc).numpy()
    jp, jc = [jnp.asarray(p) for p in pyramid], jnp.asarray(coords)
    gather = np.asarray(jraft.corr_lookup_gather(jp, jc))
    assert got.shape == gather.shape == coords.shape[:3] + (324,)
    np.testing.assert_allclose(got, gather, atol=1e-5, rtol=0)
    supported = jcl.fused_lookup_supported(jp)
    assert supported == (name != "groups17")
    if supported:
        jpacked, jmetas = jcl.pack_pyramid(jp)
        kernel = np.asarray(jcl.corr_lookup_packed(jpacked, jmetas, jc,
                                                   interpret=True))
        np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
    if name == "outside":  # whole windows outside every level: exact zeros
        assert np.all(got[:, 0] == 0.0)
    if name == "degenerate":  # the 0x0 level's 81 taps are zeros
        assert np.all(got[..., 3 * 81:] == 0.0)


@pytest.mark.parametrize("wrapper", ["level", "proj", "packed"])
def test_wrappers_never_fall_back_off_the_cpu(wrapper):
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    'meta' tensor, which no kernel takes, must raise rather than reach the
    plain version."""
    pyramid, coords = _case("random")
    tp = [torch.from_numpy(p).to("meta") for p in pyramid]
    tc = torch.from_numpy(coords).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "level":
            tcl.corr_lookup_level_cuda(tp, tc)
        elif wrapper == "packed":
            tcl.corr_lookup_packed_cuda(
                torch.zeros(coords.size // 2, 640, device="meta"),
                tcl.pack_pyramid([torch.from_numpy(p) for p in pyramid])[1],
                tc)
        else:
            tcl.corr_lookup_proj_cuda(tp, tc, torch.zeros(324, 8, device="meta"),
                                      torch.zeros(8, device="meta"))


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """The built library is named by a digest of its sources, so an edited
    kernel is rebuilt, never served from a stale build."""
    before = build.library_path()
    src = tmp_path / "k.cu"
    src.write_text("// edited\n")
    monkeypatch.setattr(build, "sources", lambda: [src])
    after = build.library_path()
    assert before != after and after.parent == build.BUILD_DIR
    assert after.name.startswith("libvft_kernels_")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PACKED_CASES)
def test_cuda_kernels_match_plain_on_card(cuda_card, name):
    pyramid, coords = _case(name)
    tp = [torch.from_numpy(p).to(cuda_card) for p in pyramid]
    tc = torch.from_numpy(coords).to(cuda_card)
    rng = np.random.default_rng(9)
    weight = torch.from_numpy((rng.normal(size=(324, 256)) * 0.05).astype(
        np.float32)).to(cuda_card)
    bias = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)).to(
        cuda_card)
    set_precision("float32")  # the plain projection's matmul in full f32
    level = tcl.corr_lookup_level_cuda(tp, tc)
    proj = tcl.corr_lookup_proj_cuda(tp, tc, weight, bias)
    packed, metas = tcl.pack_pyramid(tp)
    taps = tcl.corr_lookup_packed_cuda(packed, metas, tc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        taps.cpu().numpy(),
        tcl.corr_lookup_packed_ref(packed, metas, tc).cpu().numpy(),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        level.cpu().numpy(),
        tcl.corr_lookup_gather_ref(tp, tc).cpu().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        proj.cpu().numpy(),
        tcl.corr_lookup_proj_ref(tp, tc, weight, bias).cpu().numpy(),
        atol=1e-4, rtol=0)


def test_port_pyramid_matches_jax():
    rng = np.random.default_rng(5)
    f1 = rng.normal(size=(2, 13, 11, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 13, 11, 32)).astype(np.float32)
    want = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = traft.build_corr_pyramid(
        torch.from_numpy(f1).permute(0, 3, 1, 2),
        torch.from_numpy(f2).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
