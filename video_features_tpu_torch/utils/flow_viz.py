"""Optical-flow -> RGB rendering with the Middlebury color wheel.

The port's copy of ``video_features_tpu/utils/flow_viz.py`` (numpy only),
for the flow families' and i3d's ``show_pred``. Same visualization contract
as reference utils/flow_viz.py:20-132 (the standard public Middlebury
scheme of Baker et al. / Dana's colorwheel):
hue encodes flow direction, saturation encodes magnitude normalized by the
per-image maximum radius.
"""
from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) uint-valued color wheel spanning RY/YG/GC/CB/BM/MR arcs."""
    arcs = [("RY", 15, (255, 0, 0), (0, 255, 0)),
            ("YG", 6, (255, 255, 0), (-255, 0, 0)),
            ("GC", 4, (0, 255, 0), (0, 0, 255)),
            ("CB", 11, (0, 255, 255), (0, -255, 0)),
            ("BM", 13, (0, 0, 255), (255, 0, 0)),
            ("MR", 6, (255, 0, 255), (0, 0, -255))]
    rows = []
    for _, n, base, delta in arcs:
        t = np.arange(n, dtype=np.float64)[:, None] / n
        base = np.asarray(base, dtype=np.float64)
        delta = np.asarray(delta, dtype=np.float64)
        # the ramp term is floored BEFORE adding to the base (a descending
        # arc is 255 - floor(255*t), not floor(255 - 255*t) — off by one
        # LSB on fractional steps)
        rows.append(base + np.sign(delta) * np.floor(t * np.abs(delta)))
    return np.concatenate(rows, axis=0)


_WHEEL = make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Normalized (u, v) in [-1, 1] -> (H, W, 3) uint8 colors."""
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi           # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)           # wheel position
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), dtype=np.uint8)
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        # saturate toward white inside the unit radius, darken outside
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        ch = 2 - i if convert_to_bgr else i
        img[..., ch] = np.floor(255 * col)
    return img


def flow_to_image(flow_uv: np.ndarray, clip_flow: float = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow (pixels) -> (H, W, 3) uint8 visualization.

    Magnitude is normalized by the image's own max radius (reference
    utils/flow_viz.py:110-132), so colors are comparable within one frame
    only.
    """
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, \
        "input flow must have shape (H, W, 2)"
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u = flow_uv[..., 0]
    v = flow_uv[..., 1]
    rad_max = max(float(np.sqrt(u ** 2 + v ** 2).max()), 0.0)
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps),
                             convert_to_bgr)
