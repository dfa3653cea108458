"""Frame resizing and cropping.

Port of the parts of ``video_features_tpu/ops/preprocess.py`` the ported
families run: PIL's antialiased resize on the host or as device matmuls
(i3d, the flow families), and the clip-stack families' non-antialiased
bilinear resizes, centre crop and uint8 quantisation (r21d, s3d) in numpy.
``PIL`` is imported only inside :func:`pil_resize` (the host path); nothing
here needs cv2.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def resize_edge_size(w: int, h: int, size: int,
                     to_smaller_edge: bool = True) -> Tuple[int, int]:
    """(out_w, out_h) of PIL's aspect-preserving resize; the other edge is
    ``int(size * long / short)`` (truncated, reference transforms.py:218-229)."""
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if (w < h) == to_smaller_edge:
        return size, int(size * h / w)
    return int(size * w / h), size


def pil_resize(img: np.ndarray, size: int,
               to_smaller_edge: bool = True) -> np.ndarray:
    """Antialiased PIL bilinear resize of an HWC uint8 image to ``size`` on
    the smaller (or larger) edge."""
    from PIL import Image
    pil = Image.fromarray(img)
    w, h = pil.size
    ow, oh = resize_edge_size(w, h, size, to_smaller_edge)
    if (ow, oh) == (w, h):
        return np.asarray(pil)
    return np.asarray(pil.resize((ow, oh), Image.BILINEAR))


def center_crop(img: np.ndarray, crop: int) -> np.ndarray:
    """Centre crop of an HWC image with torchvision CenterCrop's origin
    ``int(round((H - crop) / 2))`` (banker's rounding)."""
    i = int(round((img.shape[0] - crop) / 2.0))
    j = int(round((img.shape[1] - crop) / 2.0))
    return img[i:i + crop, j:j + crop]


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8 wire format (round to nearest, clipped)."""
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _bilinear_axis_weights(n_out: int, n_in: int, scale: float):
    """Half-pixel bilinear gather indices and weights for one axis:
    ``src = (dst + 0.5) / scale - 0.5`` clamped to ``[0, n_in - 1]``."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


def _bilinear(img: np.ndarray, rows, cols, acc=np.float32) -> np.ndarray:
    """Separable bilinear resample of an HWC image to float32: the
    horizontal pass on the two source rows of each output row, then the
    vertical blend. Each pass's two products and their sum run in ``acc``
    and round to float32 once (with ``acc=np.float64`` the float32 products
    are exact)."""
    ylo, yhi, wy = rows
    xlo, xhi, wx = cols
    im = img.astype(np.float32)

    def blend(a, b, w):
        return (a.astype(acc) * (1 - w) + b.astype(acc) * w).astype(
            np.float32)

    wx = wx[None, :, None]
    top = blend(im[ylo][:, xlo], im[ylo][:, xhi], wx)
    bot = blend(im[yhi][:, xlo], im[yhi][:, xhi], wx)
    return blend(top, bot, wy[:, None, None])


def bilinear_resize_no_antialias(img: np.ndarray,
                                 out_hw: Tuple[int, int]) -> np.ndarray:
    """Non-antialiased bilinear resize of an HWC image to ``out_hw``
    (align_corners=False), float32: the sampling of cv2's
    ``INTER_LINEAR``, which the JAX package calls (reference
    models/transforms.py:76-96), source coordinate ``(dst + 0.5) * in / out
    - 0.5`` clamped at the borders, computed in numpy so no cv2 is
    needed. Each pass rounds once from exact products, which leaves cv2's
    float32 result at most one ulp away (cv2's own order of operations is
    not reproduced)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    return _bilinear(img, _bilinear_axis_weights(oh, h, oh / h),
                     _bilinear_axis_weights(ow, w, ow / w), acc=np.float64)


def bilinear_resize_by_scale(img: np.ndarray, scale: float) -> np.ndarray:
    """torch ``F.interpolate(scale_factor=scale,
    recompute_scale_factor=False)``, bilinear, no antialias: out size
    ``floor(in * scale)``, and the coordinates mapped with the exact
    ``scale`` (``src = (dst + 0.5) / scale - 0.5``), not with out/in as
    :func:`bilinear_resize_no_antialias` maps them (reference
    models/transforms.py:86-96)."""
    h, w = img.shape[:2]
    oh, ow = int(h * scale), int(w * scale)
    return _bilinear(img, _bilinear_axis_weights(oh, h, scale),
                     _bilinear_axis_weights(ow, w, scale))


def pil_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic matrix of PIL's bilinear resample
    coefficients for one axis (Pillow Resample.c precompute_coeffs): a
    triangle filter whose support scales with the downscale factor, PIL's
    antialiasing. A full resize is ``R @ img @ C.T`` per channel."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = np.maximum(0.0, 1.0 - np.abs(
            (np.arange(xmin, xmax) - center + 0.5) / filterscale))
        m[i, xmin:xmax] = w / w.sum()
    return m


def device_resize(batch_u8: torch.Tensor, rmat: torch.Tensor,
                  cmat: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, Ho, Wo, C) float32 in [0, 255]: the
    horizontal pass, round and clamp to the uint8 range (PIL stores the
    intermediate as uint8), then the vertical pass, round and clamp."""
    x = batch_u8.float()
    x = torch.einsum("ow,bhwc->bhoc", cmat, x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = torch.einsum("oh,bhwc->bowc", rmat, x)
    return torch.clamp(torch.round(x), 0.0, 255.0)


def make_device_resizer(in_h: int, in_w: int, oh: int, ow: int,
                        device: torch.device
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function resizing ``(..., in_h, in_w, C)`` uint8 frames on
    ``device`` to ``(..., oh, ow, C)`` uint8 through :func:`device_resize`
    (leading dims are flattened for the matmuls and restored)."""
    rmat = torch.from_numpy(pil_resize_matrix(in_h, oh)).to(device)
    cmat = torch.from_numpy(pil_resize_matrix(in_w, ow)).to(device)

    def resize_frames(x_u8: torch.Tensor) -> torch.Tensor:
        lead, tail = x_u8.shape[:-3], x_u8.shape[-3:]
        out = device_resize(x_u8.reshape((-1,) + tuple(tail)), rmat, cmat)
        return out.to(torch.uint8).reshape(
            tuple(lead) + (oh, ow, tail[-1]))

    return resize_frames
