"""YUV 4:2:0 wire format of the clip-stack families' ``ingest=yuv420``
(port of ``video_features_tpu/ops/colorspace.py``).

A packed frame is ``[ Y (H*W) | U (H/2*W/2) | V (H/2*W/2) ]`` uint8,
C-order: 1.5 bytes a pixel on the host-to-device copy instead of 3 (uint8
RGB) or 12 (float32 RGB). The host encodes in numpy with the fixed-point
arithmetic of cv2's ``COLOR_RGB2YUV_I420`` (studio-swing BT.601, chroma of
the top-left pixel of each 2x2 block), byte for byte what the JAX package's
cv2 call gives, so no cv2 is needed; the card decodes with plain torch ops,
nearest-neighbour chroma upsampling, which matches cv2's
``COLOR_YUV2RGB_I420`` to under one intensity level.
"""
from __future__ import annotations

import numpy as np
import torch

# studio-swing BT.601 (cv2 I420): Y in [16, 235], chroma in [16, 240]
_Y_SCALE = 1.164383
_V_TO_R = 1.596027
_U_TO_G = -0.391762
_V_TO_G = -0.812968
_U_TO_B = 2.017232


def packed_size(h: int, w: int) -> int:
    """Bytes per packed I420 frame; ``h`` and ``w`` must be even."""
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dims, got {h}x{w}")
    return h * w * 3 // 2


#: cv2's BT.601 RGB -> YUV coefficients, fixed point with 20 fractional bits
_SHIFT = 20
_TO_Y = (269484, 528482, 102760)
_TO_U = (-155188, -305135, 460324)
_TO_V = (460324, -385875, -74448)


def _fixed_point(rgb: np.ndarray, coeffs, offset: int) -> np.ndarray:
    acc = sum(c * rgb[..., i] for i, c in enumerate(coeffs))
    return (acc + (1 << (_SHIFT - 1)) + (offset << _SHIFT)) >> _SHIFT


def rgb_to_yuv420(frame_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> packed I420 (H*W*3/2,) uint8."""
    h, w = frame_u8.shape[:2]
    packed_size(h, w)
    rgb = frame_u8.astype(np.int64)
    corner = rgb[0::2, 0::2]
    return np.concatenate([_fixed_point(rgb, _TO_Y, 16).ravel(),
                           _fixed_point(corner, _TO_U, 128).ravel(),
                           _fixed_point(corner, _TO_V, 128).ravel()]
                          ).astype(np.uint8)


def yuv420_packed_to_rgb(packed: torch.Tensor, h: int, w: int
                         ) -> torch.Tensor:
    """Packed I420 uint8 (..., H*W*3/2) -> float32 RGB (..., H, W, 3) in
    [0, 255], on the tensor's device."""
    n_y = h * w
    n_c = (h // 2) * (w // 2)
    lead = packed.shape[:-1]
    y = packed[..., :n_y].reshape(*lead, h, w).float()
    u = packed[..., n_y:n_y + n_c].reshape(*lead, h // 2, w // 2)
    v = packed[..., n_y + n_c:].reshape(*lead, h // 2, w // 2)
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1).float()
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1).float()
    yc = _Y_SCALE * (y - 16.0)
    u = u - 128.0
    v = v - 128.0
    rgb = torch.stack([yc + _V_TO_R * v,
                       yc + _U_TO_G * u + _V_TO_G * v,
                       yc + _U_TO_B * u], dim=-1)
    return torch.clamp(rgb, 0.0, 255.0)
