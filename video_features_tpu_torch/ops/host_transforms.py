"""Picklable host-transform callables (port of
``video_features_tpu/ops/host_transforms.py``): the edge resize of the i3d
and flow paths, the clip-stack families' frame transforms, and the
frame-wise families' resize and crop.

The port decodes RGB (``utils/io.py _FrameStream``), so the clip-stack
transforms take RGB frames. The JAX ones take the decoder's BGR and reverse
the channels after the crop; resize and crop act on each channel alone, so
both give the same RGB result.
"""
from __future__ import annotations

import numpy as np

from . import colorspace
from . import preprocess as pp


class EdgeResize:
    """RGB frame -> PIL bilinear resize of its smaller (or, with
    ``to_smaller_edge=False``, larger) edge to ``size``, kept uint8: the i3d
    host path (reference extract_i3d.py:41-46) and the flow families'
    ``side_size`` (reference base_flow_extractor.py)."""

    def __init__(self, size: int, to_smaller_edge: bool = True):
        self.size = size
        self.to_smaller_edge = to_smaller_edge

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        return pp.pil_resize(rgb, self.size, self.to_smaller_edge)


def encode_wire(x01: np.ndarray, ingest: str) -> np.ndarray:
    """[0, 1] float HWC frame -> the wire format: itself (``float32``),
    :func:`preprocess.quantize_u8` (``uint8``) or packed I420 of that
    (``yuv420``)."""
    if ingest == "float32":
        return x01
    return encode_wire_u8(pp.quantize_u8(x01), ingest)


def encode_wire_u8(u8: np.ndarray, ingest: str) -> np.ndarray:
    """uint8 HWC frame -> the wire format: itself (``uint8``) or packed
    I420 (``yuv420``)."""
    if ingest == "uint8":
        return u8
    return colorspace.rgb_to_yuv420(u8)


class R21DTransform:
    """RGB frame -> [0, 1] float -> non-antialiased bilinear resize to
    128x171 -> centre crop 112 -> wire (reference extract_r21d.py:50-55;
    the K400 normalisation runs on the card)."""

    def __init__(self, ingest: str):
        self.ingest = ingest

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        x = rgb.astype(np.float32) / 255.0
        x = pp.bilinear_resize_no_antialias(x, (128, 171))
        return encode_wire(np.ascontiguousarray(pp.center_crop(x, 112)),
                           self.ingest)


class S3DTransform:
    """RGB frame -> [0, 1] float -> bilinear resize by the scale factor
    224 / smaller edge -> centre crop 224 -> wire (reference
    extract_s3d.py:30-35; no normalisation)."""

    def __init__(self, ingest: str):
        self.ingest = ingest

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        x = rgb.astype(np.float32) / 255.0
        scale = 224.0 / min(x.shape[0], x.shape[1])
        x = pp.bilinear_resize_by_scale(x, scale)
        return encode_wire(np.ascontiguousarray(pp.center_crop(x, 224)),
                           self.ingest)


class ResizeCropTransform:
    """RGB frame -> PIL resize of the smaller edge to ``size`` -> centre
    crop ``crop`` -> uint8 wire: resnet 256 -> 224 bilinear (reference
    extract_resnet.py:27-33), clip R -> R bicubic (extract_clip.py:69-78);
    the normalisation runs on the card."""

    def __init__(self, size: int, crop: int, interpolation: str,
                 ingest: str):
        self.size = size
        self.crop = crop
        self.interpolation = interpolation
        self.ingest = ingest

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        out = pp.pil_resize(rgb, self.size,
                            interpolation=self.interpolation)
        return encode_wire_u8(np.ascontiguousarray(
            pp.center_crop(out, self.crop)), self.ingest)
