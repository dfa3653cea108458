"""Picklable host-transform callables (port of the edge resizes of
``video_features_tpu/ops/host_transforms.py``)."""
from __future__ import annotations

import numpy as np

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
