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

The parallel plane (``parallel/mesh.py``) on two replicas of ``cuda:0``
(two cards where there are): ``DataParallelApply`` against one device
(1e-5: cuDNN may pick another algorithm for another batch size), the
FeatureStream's pinned, event-fenced D2H against ``.cpu()`` (exact), and
CLIP's tensor parallelism over a ``(data=1, model=2)`` mesh against the
replicated model (1e-4).

The multi-family CLI on the card: each family of a shared-decode
run within 1e-4 of its single-family run, with fewer frames decoded; and a
cache hit bit-equal to the miss that stored it.

The run plane's device trace: ``utils/profiling.py TraceCapture`` around
proj launches on the card writes a Chrome trace whose device events name
the proj kernel once per launch.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from video_features_tpu_torch.device import set_precision
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.models import raft as traft
from video_features_tpu_torch.ops import audio as taudio
from video_features_tpu_torch.ops import colorspace as tcs
from video_features_tpu_torch.ops import preprocess as tpp
from video_features_tpu_torch.parallel import mesh as tmesh

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


def _two_devices():
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [torch.device("cuda", 0)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 7])
def test_data_parallel_two_replicas_on_card(cuda_card, rows):
    set_precision("float32")
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 16, 3, padding=1),
                              torch.nn.ReLU(), torch.nn.Flatten(),
                              torch.nn.Linear(16 * 8 * 8, 10)).eval()

    def fn(m, b):
        return m(b.permute(0, 3, 1, 2).float() / 255.0)

    one = tmesh.DataParallelApply(fn, net, tmesh.get_mesh("cuda:0"))
    two = tmesh.DataParallelApply(
        fn, torch.nn.Sequential(*[m for m in net]),
        tmesh.get_mesh(devices=_two_devices()))
    x = np.random.default_rng(rows).integers(
        0, 256, size=(rows, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(two(x), one(x), rtol=0, atol=1e-5)
    chunks = two.dispatch(x)
    assert [c.device for c in chunks] == _two_devices()[:len(chunks)]


@pytest.mark.cuda
def test_feature_stream_pinned_copy_equals_cpu(cuda_card):
    runner = tmesh.DataParallelApply(
        lambda m, b: b.float().cumsum(dim=1), torch.nn.Identity(),
        tmesh.get_mesh(devices=_two_devices()))
    stream = runner.stream(depth=2)
    batches = [np.random.default_rng(i).normal(size=(5, 4096)).astype(
        np.float32) for i in range(4)]
    for b in batches:
        stream.submit(b)
    for got, b in zip(stream.finish(), batches):
        want = torch.cat([c.cpu() for c in runner.dispatch(b)]).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128])
def test_clip_tensor_parallel_on_card(cuda_card, width):
    from video_features_tpu_torch.models import clip as tclip
    from video_features_tpu_torch.weights.bridge import seeded_init_

    set_precision("float32")
    model = seeded_init_(tclip.CLIP(tclip._cfg(128, 32, 2, width, 16, 64,
                                                2)), 0).eval()
    specs = tmesh.param_specs_by_rules(model, tmesh.TP_RULES_TRANSFORMER)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)

    def fn(m, b):
        return m.encode_image(b)

    ref = tmesh.DataParallelApply(fn, model, tmesh.get_mesh("cuda:0"))(x)
    tp = tmesh.DataParallelApply(
        fn, model, tmesh.get_mesh(devices=_two_devices(),
                                  axis_names=("data", "model"),
                                  shape=(1, 2)),
        shard=lambda m, devs: tclip.tensor_parallel(m, devs, specs))
    attn = tp.replicas[0].visual.transformer.resblocks[0].attn
    assert [tuple(s.in_proj_weight.shape) for s in attn.shards] == \
        [(3 * width // 2, width)] * 2
    np.testing.assert_allclose(tp(x), ref, rtol=0, atol=1e-4)


SAMPLE = str(Path(__file__).resolve().parent / "assets" /
             "v_synth_sample.mp4")


def _stub_rip(video_path, tmp_path):
    """A seeded 2.5 s tone for the sample's missing audio track."""
    import os
    import wave
    os.makedirs(tmp_path, exist_ok=True)
    stem = os.path.splitext(os.path.basename(video_path))[0]
    t = np.arange(40000) / 16000.0
    wav = os.path.join(tmp_path, f"{stem}.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.4 * np.sin(2 * np.pi * 330 * t) * 32767).astype(
            "<i2").tobytes())
    aac = os.path.join(tmp_path, f"{stem}.aac")
    open(aac, "wb").close()
    return wav, aac


@pytest.mark.cuda
def test_multi_family_cli_on_card_matches_single_runs(cuda_card, tmp_path,
                                                      monkeypatch):
    """``feature_type=r21d,resnet,vggish`` on the card over one decode:
    each family's outputs within 1e-4 of its single-family run (the same
    seeded weights), with fewer frames decoded than the singles'."""
    import contextlib
    import io

    from video_features_tpu_torch.cli import main
    from video_features_tpu_torch.utils import io as tio

    monkeypatch.setattr("video_features_tpu_torch.extractors.vggish."
                        "extract_wav_from_mp4", _stub_rip)
    over = {"resnet": ["model_name=resnet18", "extraction_total=6",
                       "batch_size=8"],
            "r21d": ["extraction_fps=1", "stack_size=10", "step_size=10"],
            "vggish": []}
    base = ["device=cuda", "allow_random_weights=true",
            "on_extraction=save_numpy", f"tmp_path={tmp_path / 't'}",
            f"video_paths={SAMPLE}"]
    decoded = {}
    with contextlib.redirect_stdout(io.StringIO()):
        before = tio.decoded_frames()
        for fam, kv in over.items():
            main([f"feature_type={fam}", f"output_path={tmp_path / 's'}"]
                 + kv + base)
        decoded["singles"] = tio.decoded_frames() - before
        before = tio.decoded_frames()
        main([f"feature_type={','.join(over)}",
              f"output_path={tmp_path / 'm'}"]
             + [f"{f}.{x}" for f, kv in over.items() for x in kv] + base)
        decoded["shared"] = tio.decoded_frames() - before
    singles = sorted(p.relative_to(tmp_path / "s")
                     for p in (tmp_path / "s").rglob("*.npy"))
    assert len(singles) == 5
    for rel in singles:
        np.testing.assert_allclose(np.load(tmp_path / "m" / rel),
                                   np.load(tmp_path / "s" / rel), rtol=0,
                                   atol=1e-4, err_msg=str(rel))
    assert 0 < decoded["shared"] < decoded["singles"]


@pytest.mark.cuda
def test_cache_hit_on_card_bit_equal_to_its_miss(cuda_card, tmp_path):
    """resnet18 on the card with ``cache=true``: the first extraction
    stores, a second extractor into another output dir is served from the
    entry without decoding, bit for bit."""
    import contextlib
    import io

    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    from video_features_tpu_torch.utils import io as tio

    def extractor(out):
        cfg = tconfig.load_config("resnet", {
            "device": "cuda", "model_name": "resnet18",
            "extraction_total": 6, "batch_size": 8, "cache": True,
            "cache_dir": str(tmp_path / "cache"),
            "on_extraction": "save_numpy", "allow_random_weights": True,
            "video_paths": SAMPLE, "output_path": str(tmp_path / out),
            "tmp_path": str(tmp_path / "t")})
        tconfig.sanity_check(cfg)
        return ExtractResNet(cfg)

    with contextlib.redirect_stdout(io.StringIO()):
        miss = extractor("a")._extract(SAMPLE)
        served = extractor("b")
        served.extract = None  # a hit never extracts
        before = tio.decoded_frames()
        hit = served._extract(SAMPLE)
    assert tio.decoded_frames() == before
    assert set(hit) == set(miss)
    for key in miss:
        assert np.asarray(hit[key]).tobytes() == \
            np.asarray(miss[key]).tobytes(), key


@pytest.mark.cuda
def test_trace_capture_on_card_names_the_proj_kernel(cuda_card, tmp_path):
    import json

    from video_features_tpu_torch.utils.profiling import TraceCapture

    pyramid, coords = _case("random")
    tp = [torch.from_numpy(p).to(cuda_card) for p in pyramid]
    tc = torch.from_numpy(coords).to(cuda_card)
    weight = torch.full((324, 256), 0.01, device=cuda_card)
    bias = torch.zeros(256, device=cuda_card)
    tcl.corr_lookup_proj_cuda(tp, tc, weight, bias)  # build before the trace
    torch.cuda.synchronize()
    with TraceCapture(str(tmp_path)) as cap:
        for _ in range(3):
            tcl.corr_lookup_proj_cuda(tp, tc, weight, bias)
        torch.cuda.synchronize()
    assert cap.path is not None and Path(cap.path).parent == tmp_path
    events = json.loads(Path(cap.path).read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("proj_kernel" in name for name in kernels) == 3, kernels
