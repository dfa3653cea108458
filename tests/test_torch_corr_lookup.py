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
held against the JAX gather only). The ``nonfinite`` case has NaN, +inf,
-inf and +-1e30 coords: the plain versions return, as the JAX functions do,
zeros from the gather (``relu(bias)`` from the projection) and NaN from the
packed and one-hot formulations (their weights ``c - floor(c)`` are NaN),
held NaN for NaN. The card-only tests, which hold each CUDA kernel against
its plain version on the card, are in tests/test_torch_cuda.py, which
imports no JAX and so can be collected on a machine without it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.kernels import corr_lookup as jcl
from video_features_tpu.models import raft as jraft
from video_features_tpu_torch.kernels import build
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.models import raft as traft


def _case(name):
    """(pyramid levels (B, P, Hl, Wl) np, coords (B, H, W, 2) np) for the
    cases of tests/test_kernels.py: random coords spread slightly past the
    plane, integer coords, whole windows out of the plane, odd level sizes
    and a pyramid that pools down to 1x1 and 0x0; 3 pairs on a 7x11 grid
    (Q = 231, no whole tile of the CUDA kernels); and non-finite and huge
    coords."""
    rng = np.random.default_rng({"random": 0, "integer": 1, "outside": 2,
                                 "odd": 3, "degenerate": 4, "wide": 5,
                                 "groups17": 6, "q231": 7,
                                 "nonfinite": 8}[name])
    b, h8, w8, c = {"odd": (2, 13, 11, 32), "degenerate": (1, 6, 5, 16),
                    "wide": (1, 3, 130, 16), "groups17": (1, 34, 43, 8),
                    "q231": (3, 7, 11, 32)}.get(name, (1, 12, 10, 64))
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
    if name == "nonfinite":
        coords[0, 0, 0, 0] = np.nan   # x
        coords[0, 0, 1, 1] = np.nan   # y
        coords[0, 1, 2, 0] = np.inf
        coords[0, 2, 3, 1] = -np.inf
        coords[0, 3, 4, 0] = 1e30     # finite, far outside every level
        coords[0, 4, 5, 1] = -1e30
    return pyramid, coords


CASES = ["random", "integer", "outside", "odd", "degenerate", "q231",
         "nonfinite"]
#: the packed layout's own edge cases: a level wider than 128 lanes, and
#: 17 row groups at level 0 (past the JAX kernel's G <= 16 gate)
PACKED_CASES = CASES + ["wide", "groups17"]


def _torch(pyramid, coords):
    return [torch.from_numpy(p) for p in pyramid], torch.from_numpy(coords)


def _finite(coords):
    """(B, H, W) mask of the queries whose two coords are finite."""
    return np.isfinite(coords).all(-1)


def test_nonfinite_case_has_nan_inf_and_huge_coords():
    _, coords = _case("nonfinite")
    assert np.isnan(coords).sum() == 2 and np.isinf(coords).sum() == 2
    assert (np.abs(coords) == np.float32(1e30)).sum() == 2
    assert _finite(coords).sum() == coords.size // 2 - 4


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
    np.testing.assert_allclose(got, gather, atol=1e-5, rtol=0,
                               equal_nan=True)
    # the JAX kernel takes no level of zero size (degenerate's 0x0, q231's
    # 0x1 fourth level), and its one-hot selectors give NaN, not the
    # gather's zeros, for a non-finite coord
    finite = _finite(coords)
    if name not in ("degenerate", "q231"):
        pallas = np.asarray(jcl.corr_lookup_pallas(jp, jc, interpret=True))
        np.testing.assert_allclose(got[finite], pallas[finite], atol=1e-5,
                                   rtol=0)
    if name == "outside":  # whole windows outside every level: exact zeros
        assert np.all(got[:, 0] == 0.0)
    # a non-finite coord: zeros, as the JAX gather gives
    assert np.all(got[~finite] == 0.0)


@pytest.mark.parametrize("name", CASES)
def test_onehot_lookup_matches_jax(name):
    pyramid, coords = _case(name)
    got = tcl.corr_lookup_onehot_ref(*_torch(pyramid, coords)).numpy()
    want = np.asarray(jcl.corr_lookup_onehot(
        [jnp.asarray(p) for p in pyramid], jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, equal_nan=True)
    assert np.isnan(got[~_finite(coords)]).all()


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
    gather = np.asarray(jraft.corr_lookup_gather(jp, jc))
    assert got.shape == ref.shape == coords.shape[:3] + (24,)
    np.testing.assert_allclose(got, np.maximum(gather @ weight + bias, 0),
                               atol=1e-4, rtol=0)
    # the JAX projections' one-hot selectors give NaN for a non-finite coord
    # (the Pallas kernel only for a NaN); the gather's zeros give relu(bias)
    finite = _finite(coords)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[finite], kernel[finite], atol=1e-4,
                               rtol=0)
    if name == "outside":  # zeros rule: relu(bias) exactly
        np.testing.assert_array_equal(
            got[:, 0], np.broadcast_to(np.maximum(bias, 0), got[:, 0].shape))
    np.testing.assert_array_equal(
        got[~finite],
        np.broadcast_to(np.maximum(bias, 0), got[~finite].shape))


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
    # a non-finite coord: NaN weights (c - floor(c)), so NaN taps where the
    # gather gives zeros, as the JAX packed kernel gives
    finite = _finite(coords)
    np.testing.assert_allclose(got[finite], gather[finite], atol=1e-5,
                               rtol=0)
    assert np.isnan(got[~finite]).all()
    supported = jcl.fused_lookup_supported(jp)
    assert supported == (name != "groups17")
    if supported:
        jpacked, jmetas = jcl.pack_pyramid(jp)
        kernel = np.asarray(jcl.corr_lookup_packed(jpacked, jmetas, jc,
                                                   interpret=True))
        np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0,
                                   equal_nan=True)
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


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111proj_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111proj_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compile time = 224.609 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112level_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112level_kernelEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 8 bytes cumulative stack size, 28736 bytes smem
"""


def test_ptxas_report_gives_registers_smem_and_spills():
    """The build keeps nvcc's -Xptxas -v report beside the library; each
    kernel's registers, static shared memory and spills are read from it."""
    assert "-Xptxas=-v" in build.NVCC_FLAGS
    assert build.report_path(build.library_path()).name.endswith(
        ".so.ptxas.txt")
    assert build.kernel_resources(PTXAS_REPORT) == {
        "_ZN12_GLOBAL__N_111proj_kernelEv": dict(
            registers=128, smem_bytes=0, stack_frame_bytes=0,
            spill_store_bytes=0, spill_load_bytes=0),
        "_ZN12_GLOBAL__N_112level_kernelEv": dict(
            registers=72, smem_bytes=28736, stack_frame_bytes=8,
            spill_store_bytes=4, spill_load_bytes=4)}


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
