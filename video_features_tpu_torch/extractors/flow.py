"""Pair-wise optical-flow extraction (port of
``video_features_tpu/extractors/flow.py``, reference
models/_base/base_flow_extractor.py).

  host:   decode ``batch_size + 1`` frames per batch with a 1-frame overlap
          between batches (N+1 frames -> N flows), the optional PIL edge
          resize (``side_size``, ``resize_to_smaller_edge``), uint8 pairs
  device: ``(B, 2, H, W, 3)`` uint8 pairs -> the optional device resize
          (``resize=device``, only with ``side_size``) -> the family's flow
          net -> ``(B, H, W, 2)`` float32 flow

Timestamps drop the duplicate overlap timestamp between consecutive batches
(base_flow_extractor.py:94-95); a single-frame batch yields no pair but its
timestamp. Saved flows are channel-first ``(N, 2, H, W)``, as the reference
stores them.

``extract(video_path)`` decodes in batches on a background thread;
``extract_frames(frames, fps)`` takes any iterable of
``(frame_rgb_u8, t, idx)`` (a seam for synthetic frames).

Output keys: ``[feature_type, fps, timestamps_ms]``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import host_transforms as ht
from ..runner import Runner
from ..utils.io import Prefetcher, _batched
from .base import BaseExtractor


class OpticalFlowExtractor(BaseExtractor):
    """Families implement ``flow``: ``(B, 2, H, W, 3)`` uint8 pairs on the
    device -> ``(B, H, W, 2)`` float32 flow on the device."""

    def __init__(self, args: Config) -> None:
        super().__init__(args)
        self.batch_size = int(args.get("batch_size") or 1)
        self.side_size = args.get("side_size")
        self.resize_to_smaller_edge = bool(args.get("resize_to_smaller_edge",
                                                    True))
        self.extraction_fps = args.get("extraction_fps")
        self.extraction_total = args.get("extraction_total")
        self.output_feat_keys = [self.feature_type, "fps", "timestamps_ms"]
        # without side_size there is no resize at all: 'auto' and an
        # explicit 'device' both come down to the host path's no-op
        self.resize_mode = self._resolve_resize_mode(args)
        if self.side_size is None:
            self.resize_mode = "host"
        self.host_transform = None
        if self.side_size is not None and self.resize_mode == "host":
            self.host_transform = ht.EdgeResize(int(self.side_size),
                                                self.resize_to_smaller_edge)
        self.runner = Runner(self._forward, self.device)

    def flow(self, pairs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _forward(self, pairs: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W, 3) uint8 on the device -> (B, H', W', 2) float32."""
        if self.resize_mode == "device":
            pairs = self._edge_resizer(
                pairs.shape[2], pairs.shape[3], int(self.side_size),
                self.resize_to_smaller_edge)(pairs)
        return self.flow(pairs)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        src = self.video_source(video_path, fps=self.extraction_fps,
                                total=self.extraction_total,
                                batch_size=self.batch_size + 1,  # N+1 flows
                                transform=self.host_transform, overlap=1)
        # decode-ahead: the next batch decodes while this one computes
        return self._extract_batches(Prefetcher(src), src.fps)

    def extract_frames(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                       fps: float) -> Dict[str, np.ndarray]:
        """Flows of a decoded frame stream: ``frames`` yields
        ``(frame_rgb_u8 (H, W, 3), t, idx)``; ``fps`` is the stream's
        rate."""
        if self.host_transform is not None:
            tf = self.host_transform
            frames = ((tf(f), t, i) for f, t, i in frames)
        return self._extract_batches(
            _batched(iter(frames), self.batch_size + 1, 1), fps)

    def _extract_batches(self, batches, fps: float) -> Dict[str, np.ndarray]:
        flows: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        first = True
        for batch, ts, _ in batches:
            if len(batch) >= 2:  # a lone frame yields no pair
                arr = np.stack(batch)  # (n, H, W, 3) uint8
                out = self.runner(np.stack([arr[:-1], arr[1:]], axis=1))
                flows.extend(out.transpose(0, 3, 1, 2))
            timestamps_ms.extend(ts if first else ts[1:])
            first = False
        return {self.feature_type: np.array(flows), "fps": np.array(fps),
                "timestamps_ms": np.array(timestamps_ms)}
