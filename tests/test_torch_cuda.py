"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card (the
kernels have no CPU mode). The module imports neither JAX nor the JAX
package, so it can be collected on a machine that has only torch:

    python -m pytest -m cuda tests/test_torch_cuda.py

The cases are those of tests/test_torch_corr_lookup.py, built from the same
numpy seeds: random coords spread slightly past the plane, integer coords,
whole windows out of the plane, odd level sizes, a pyramid that pools down
to 1x1 and 0x0, 3 pairs on a 7x11 grid (Q = 231, no whole tile of the
kernels), NaN / +-inf / +-1e30 coords, a level wider than 128 and 17 row
groups. Their pyramids come from the port's ``build_corr_pyramid``, which
tests/test_torch_corr_lookup.py holds to the JAX one within 1e-5.
Tolerances: level and packed 1e-5, the fused projection 1e-4 (its 324-term
sum runs in another order); NaN where the plain version gives NaN.
"""
import numpy as np
import pytest
import torch

from video_features_tpu_torch.device import set_precision
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.models import raft as traft

CASES = ["random", "integer", "outside", "odd", "degenerate", "q231",
         "nonfinite"]
#: the packed layout's own edge cases: a level wider than 128 lanes, and
#: 17 row groups at level 0
PACKED_CASES = CASES + ["wide", "groups17"]


def _case(name):
    """(pyramid levels (B, P, Hl, Wl) np, coords (B, H, W, 2) np)."""
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
        f1 *= 0.25  # correlations of about 1
    pyramid = [p.numpy() for p in traft.build_corr_pyramid(
        torch.from_numpy(f1).permute(0, 3, 1, 2),
        torch.from_numpy(f2).permute(0, 3, 1, 2))]
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


@pytest.mark.cuda
def test_cuda_proj_rejects_unsupported_shapes(cuda_card):
    """The fused kernel takes convc1's 256 output channels and 16-byte
    aligned weight and bias; anything else raises, never falls back."""
    pyramid, coords = _case("q231")
    tp = [torch.from_numpy(p).to(cuda_card) for p in pyramid]
    tc = torch.from_numpy(coords).to(cuda_card)
    with pytest.raises(ValueError, match="256 output channels"):
        tcl.corr_lookup_proj_cuda(tp, tc,
                                  torch.zeros(324, 24, device=cuda_card),
                                  torch.zeros(24, device=cuda_card))
    shifted = torch.zeros(324 * 256 + 1, device=cuda_card)[1:].view(324, 256)
    with pytest.raises(ValueError, match="aligned"):
        tcl.corr_lookup_proj_cuda(tp, tc, shifted,
                                  torch.zeros(256, device=cuda_card))
