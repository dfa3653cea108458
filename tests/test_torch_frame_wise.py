"""The port's frame-wise plane (resnet, clip) against the JAX package's:
resizes, the I420 raw wire, the host transform, the decode and the
extractor's seams.

- ``pil_resize_matrix`` bilinear and bicubic equal JAX's exactly at
  several sizes, down and up;
- the device resize (``make_device_resizer``) against JAX's, bilinear and
  bicubic, on RGB frames and on I420 planes through
  ``yuv420_frame_to_rgb_u8``: at most 1 LSB apart, on under 0.1% of the
  values (the two sum the matmuls in other orders); the I420 decode to
  uint8 equals JAX's;
- ``ResizeCropTransform`` (256 -> 224 bilinear, 224 -> 224 bicubic, uint8
  and yuv420) equals JAX's byte for byte on the sample video's frames, and
  ``VideoSource(channel_order='i420')`` delivers JAX's planes;
- ``extract_frames`` (frames from any iterable) gives ``extract``'s
  features, exactly, for both resizes and both wires; a source with odd
  dimensions falls back to the RGB wire with a warning, as JAX's does;
- ``resize=auto`` resolves as JAX's does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_r21d import video_frames
from video_features_tpu.ops import colorspace as jcs
from video_features_tpu.ops import host_transforms as jht
from video_features_tpu.ops import preprocess as jpp
from video_features_tpu.utils import io as jio
from video_features_tpu_torch.ops import colorspace as tcs
from video_features_tpu_torch.ops import host_transforms as tht
from video_features_tpu_torch.ops import preprocess as tpp
from video_features_tpu_torch.utils import io as tio

SIZES = [(320, 224), (240, 224), (224, 224), (100, 256), (57, 91),
         (480, 336), (13, 7), (7, 13)]


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_pil_resize_matrix_equals_jax(interpolation, n_in, n_out):
    got = tpp.pil_resize_matrix(n_in, n_out, interpolation)
    want = jpp.pil_resize_matrix(n_in, n_out, interpolation)
    assert got.dtype == want.dtype and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got, want)


def assert_within_one_lsb(got, want, share=1e-3):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < share, ((d > 0).mean())


@pytest.mark.parametrize("interpolation,size", [("bilinear", 256),
                                                ("bicubic", 224),
                                                ("bicubic", 336)])
@pytest.mark.parametrize("wire", ["rgb", "i420"])
def test_device_resize_matches_jax(interpolation, size, wire):
    frames = np.stack(video_frames(3, 8))  # (3, 240, 320, 3)
    ow, oh = tpp.resize_edge_size(320, 240, size)
    port = tpp.make_device_resizer(240, 320, oh, ow, torch.device("cpu"),
                                   interpolation)
    jres = jpp.make_device_resizer(240, 320, oh, ow, interpolation)
    if wire == "i420":
        planes = np.stack([tcs.rgb_to_yuv420(f).reshape(360, 320)
                           for f in frames])
        tin = tcs.yuv420_frame_to_rgb_u8(torch.from_numpy(planes), 240, 320)
        jin = jcs.yuv420_frame_to_rgb_u8(jnp.asarray(planes), 240, 320)
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    else:
        tin, jin = torch.from_numpy(frames), jnp.asarray(frames)
    got = port(tin).numpy()
    want = np.asarray(jres(jin))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (3, oh, ow, 3)
    assert_within_one_lsb(got, want)


@pytest.fixture(scope="module")
def sample_frames(sample_video):
    """Every 20th frame of the sample video, decoded RGB."""
    src = tio.VideoSource(sample_video)
    return [f for f, _, i in src.frames() if i % 20 == 0]


@pytest.mark.parametrize("size,crop,interpolation", [
    (256, 224, "bilinear"), (224, 224, "bicubic")])
@pytest.mark.parametrize("ingest", ["uint8", "yuv420"])
def test_resize_crop_transform_equals_jax(sample_frames, size, crop,
                                          interpolation, ingest):
    port = tht.ResizeCropTransform(size, crop, interpolation, ingest)
    jax_ = jht.ResizeCropTransform(size, crop, interpolation, ingest)
    for frame in sample_frames:
        got, want = port(frame), jax_(frame)
        assert got.dtype == np.uint8
        assert got.shape == ((crop, crop, 3) if ingest == "uint8"
                             else (crop * crop * 3 // 2,))
        np.testing.assert_array_equal(got, want)


def test_i420_decode_equals_jax(sample_video):
    got = list(tio.VideoSource(sample_video, total=6,
                               channel_order="i420").frames())
    want = list(jio.VideoSource(sample_video, total=6,
                                channel_order="i420").frames())
    assert len(got) == len(want) == 6
    for (g, gt, gi), (w, wt, wi) in zip(got, want):
        assert (gt, gi) == (wt, wi) and g.shape == (360, 320)
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="channel_order"):
        next(tio.VideoSource(sample_video, total=1,
                             channel_order="bgr").frames())


def _resnet(tmp_path, video, **over):
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    cfg = dict(video_paths=video, device="cpu", model_name="resnet18",
               batch_size=3, extraction_total=5, allow_random_weights=True,
               output_path=str(tmp_path / "o"), tmp_path=str(tmp_path / "t"))
    cfg.update(over)
    args = tconfig.load_config("resnet", cfg)
    tconfig.sanity_check(args)
    return ExtractResNet(args)


@pytest.mark.parametrize("resize", ["host", "device"])
@pytest.mark.parametrize("ingest", ["uint8", "yuv420"])
def test_extract_frames_equals_extract(tmp_path, sample_video, resize,
                                       ingest):
    """The decode path (cv2's I420 of the decoded frame under
    ``resize=device``) and the seam (the port's numpy I420 of the RGB
    frame) put the same bytes on the wire."""
    ex = _resnet(tmp_path, sample_video, resize=resize, ingest=ingest)
    want = ex.extract(sample_video)
    src = tio.VideoSource(sample_video, total=5)
    got = ex.extract_frames(src.frames(), src.fps)
    assert got["resnet"].shape == (5, 512)
    for key in ("resnet", "fps", "timestamps_ms"):
        np.testing.assert_array_equal(got[key], want[key])


def test_odd_dimensions_fall_back_to_rgb_wire(tmp_path, sample_video,
                                              capsys):
    frames = [f[:239, :319] for f in video_frames(4, 9)]
    stream = [(f, i * 40.0, i) for i, f in enumerate(frames)]
    feats = {}
    for ingest in ("yuv420", "uint8"):
        ex = _resnet(tmp_path, sample_video, resize="device", ingest=ingest)
        feats[ingest] = ex.extract_frames(iter(stream), 25.0)
    assert "odd dimensions 239x319" in capsys.readouterr().out
    np.testing.assert_array_equal(feats["yuv420"]["resnet"],
                                  feats["uint8"]["resnet"])
    np.testing.assert_array_equal(feats["uint8"]["timestamps_ms"],
                                  [0.0, 40.0, 80.0, 120.0])


def test_empty_stream(tmp_path, sample_video):
    out = _resnet(tmp_path, sample_video).extract_frames([], 25.0)
    assert out["resnet"].shape == out["timestamps_ms"].shape == (0,)


@pytest.mark.parametrize("on_extraction,show_pred,want", [
    ("save_numpy", False, "device"), ("save_pickle", False, "device"),
    ("print", False, "host"), ("save_numpy", True, "host")])
def test_resize_auto_resolves_as_jax(tmp_path, sample_video, on_extraction,
                                     show_pred, want):
    ex = _resnet(tmp_path, sample_video, on_extraction=on_extraction,
                 show_pred=show_pred)
    assert ex.resize_mode == want
