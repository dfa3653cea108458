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

The frame-wise families' device resize (PIL's bilinear and bicubic
coefficients as two matmuls) and I420 decode on the card against the same
functions on the CPU, which tests/test_torch_frame_wise.py holds to JAX's:
at most 1 LSB apart on under 0.1% of the values, any batch.

VGGish's device frontend (``ops/audio.py logmel_examples``: cuFFT and a
float32 matmul on the card) against the numpy frontend, which
tests/test_torch_vggish.py holds to JAX's, on noise and on silence: 1e-4,
the JAX package's own bar.
"""
import numpy as np
import pytest
import torch

from video_features_tpu_torch.device import set_precision
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.models import raft as traft
from video_features_tpu_torch.ops import audio as taudio
from video_features_tpu_torch.ops import colorspace as tcs
from video_features_tpu_torch.ops import preprocess as tpp

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


def _frames(batch, seed=0):
    """Smooth gradients plus seeded noise, uint8 (batch, 240, 320, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    out = [np.stack([127 + 100 * np.sin(xx / 23 + t),
                     127 + 100 * np.sin(yy / 17 - t),
                     127 + 100 * np.sin((xx + yy) / 31)], -1)
           + rng.normal(0, 8, (240, 320, 3)) for t in range(batch)]
    return np.stack(out).clip(0, 255).astype(np.uint8)


def _within_one_lsb(got, want):
    d = (got.astype(np.int64) - want.astype(np.int64))
    d = np.abs(d)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d > 0).mean()


@pytest.mark.cuda
@pytest.mark.parametrize("interpolation,size", [("bilinear", 256),
                                                ("bicubic", 224)])
@pytest.mark.parametrize("batch", [1, 5])
def test_device_resize_on_card_matches_cpu(cuda_card, interpolation, size,
                                           batch):
    set_precision("float32")
    frames = torch.from_numpy(_frames(batch))
    ow, oh = tpp.resize_edge_size(320, 240, size)
    on_cpu = tpp.make_device_resizer(240, 320, oh, ow, torch.device("cpu"),
                                     interpolation)(frames)
    on_card = tpp.make_device_resizer(240, 320, oh, ow, cuda_card,
                                      interpolation)(frames.to(cuda_card))
    assert on_card.dtype == torch.uint8
    assert tuple(on_card.shape) == (batch, oh, ow, 3)
    _within_one_lsb(on_card.cpu().numpy(), on_cpu.numpy())


@pytest.mark.cuda
def test_i420_decode_on_card_matches_cpu(cuda_card):
    planes = torch.from_numpy(np.stack(
        [tcs.rgb_to_yuv420(f).reshape(360, 320) for f in _frames(3, 1)]))
    on_cpu = tcs.yuv420_frame_to_rgb_u8(planes, 240, 320)
    on_card = tcs.yuv420_frame_to_rgb_u8(planes.to(cuda_card), 240, 320)
    _within_one_lsb(on_card.cpu().numpy(), on_cpu.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("signal", ["noise", "silence"])
def test_logmel_examples_on_card_matches_numpy(cuda_card, signal):
    rng = np.random.default_rng(4)
    wav = (rng.normal(scale=0.1, size=80000) if signal == "noise"
           else np.zeros(80000))
    chunks = torch.from_numpy(taudio.chunk_waveform(wav, 16000))
    got = taudio.logmel_examples(chunks.to(cuda_card)).cpu().numpy()
    want = taudio.waveform_to_examples(wav, 16000)
    assert got.shape == want.shape == (5, 96, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
