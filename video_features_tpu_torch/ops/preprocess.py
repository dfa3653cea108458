"""Frame resizing: PIL on the host, or PIL's coefficients as device matmuls.

Port of the parts of ``video_features_tpu/ops/preprocess.py`` the i3d slice
runs. ``PIL`` is imported only inside :func:`pil_resize` (the host path).
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
