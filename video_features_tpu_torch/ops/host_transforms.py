"""Picklable host-transform callables (port of the i3d one of
``video_features_tpu/ops/host_transforms.py``)."""
from __future__ import annotations

import numpy as np

from . import preprocess as pp


class MinSideResize:
    """RGB frame -> smaller-edge PIL bilinear resize, kept uint8 (the i3d
    host path; reference extract_i3d.py:41-46)."""

    def __init__(self, min_side: int):
        self.min_side = min_side

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        return pp.pil_resize(rgb, self.min_side)
