"""Pair-wise optical-flow extraction (port of
``video_features_tpu/extractors/flow.py``, reference
models/_base/base_flow_extractor.py).

  host:   decode ``batch_size + 1`` frames per batch with a 1-frame overlap
          between batches (N+1 frames -> N flows), the optional PIL edge
          resize (``side_size``, ``resize_to_smaller_edge``), uint8 pairs
  device: ``(B, 2, H, W, 3)`` uint8 pairs, split over the data mesh
          (``parallel/mesh.py`` ``DataParallelApply``) -> the optional
          device resize (``resize=device``, only with ``side_size``) -> the
          family's flow net on each replica's card -> ``(B, H, W, 2)``
          float32 flow, back through the video's ``FeatureStream``

Timestamps drop the duplicate overlap timestamp between consecutive batches
(base_flow_extractor.py:94-95); a single-frame batch yields no pair but its
timestamp. Saved flows are channel-first ``(N, 2, H, W)``, as the reference
stores them.

``show_pred`` (base_flow_extractor.py:139-154) runs each batch
synchronously and shows every flow, drawn by ``utils/flow_viz.py``, under
the first frame of its pair in a cv2 window, one key press a frame; where
there is no display (``cv2.error``) it writes ``{tmp_path}/flow_pred_{i}.png``
instead and prints the path. cv2 is imported there only.

``extract(video_path)`` decodes in batches on a background thread;
``extract_frames(frames, fps)`` takes any iterable of
``(frame_rgb_u8, t, idx)`` (a seam for synthetic frames).

Output keys: ``[feature_type, fps, timestamps_ms]``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops import host_transforms as ht
from ..parallel.mesh import DataParallelApply, Mesh
from ..utils import flow_viz
from ..utils.io import Prefetcher, _batched
from .base import BaseExtractor


def flow_overlay(rgb: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """The (2H, W, 3) BGR float image in [0, 1] that ``show_pred`` shows:
    the (H, W, 3) uint8 frame over the colour wheel of its (H, W, 2)
    flow."""
    vis = flow_viz.flow_to_image(flow)
    stacked = np.concatenate([rgb.astype(np.float32),
                              vis.astype(np.float32)], axis=0)
    return stacked[:, :, ::-1] / 255.0


class OpticalFlowExtractor(BaseExtractor):
    """Families set ``model`` and implement ``flow``: ``(B, 2, H, W, 3)``
    uint8 pairs on a replica's device -> ``(B, H, W, 2)`` float32 flow
    there; :meth:`_build_runner` puts ``model`` on the data mesh."""

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
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
        self._host_resize_for_show_pred()
        self.host_transform = None
        if self.side_size is not None and self.resize_mode == "host":
            self.host_transform = ht.EdgeResize(int(self.side_size),
                                                self.resize_to_smaller_edge)
        self.runner: DataParallelApply = None

    def _build_runner(self) -> None:
        self.runner = DataParallelApply(self._forward, self.model,
                                        self._data_mesh())

    def flow(self, model: nn.Module, pairs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _forward(self, model: nn.Module, pairs: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W, 3) uint8 on ``model``'s device -> (B, H', W', 2)
        float32."""
        if self.resize_mode == "device":
            pairs = self._edge_resizer(
                pairs.shape[2], pairs.shape[3], int(self.side_size),
                pairs.device, self.resize_to_smaller_edge)(pairs)
        return self.flow(model, pairs)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        src = self.video_source(video_path, fps=self.extraction_fps,
                                total=self.extraction_total,
                                batch_size=self.batch_size + 1,  # N+1 flows
                                transform=self.host_transform, overlap=1)
        # decode-ahead: the next batch decodes while this one computes
        return self._extract_batches(Prefetcher(src), src.fps, video_path)

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

    def _extract_batches(self, batches, fps: float,
                         video: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
        """Flows of ``(frames, timestamps, indices)`` batches; with
        ``parity=true`` and a ``video`` each batch's raw ``(n, H, W, 2)``
        field is the backbone seam, as it came off the card."""
        stream = self.feature_stream(self.runner,
                                     on_result=self.maybe_show_pred)
        timestamps_ms: List[float] = []
        first = True
        for batch, ts, _ in batches:
            if len(batch) >= 2:  # a lone frame yields no pair
                arr = np.stack(batch)  # (n, H, W, 3) uint8
                stream.submit(np.stack([arr[:-1], arr[1:]], axis=1),
                              ctx=arr)
            timestamps_ms.extend(ts if first else ts[1:])
            first = False
        outs = stream.finish()
        self.tap_backbone(outs, video)
        flows = [f for out in outs for f in out.transpose(0, 3, 1, 2)]
        return {self.feature_type: np.array(flows), "fps": np.array(fps),
                "timestamps_ms": np.array(timestamps_ms)}

    def maybe_show_pred(self, flows: np.ndarray,
                        rgb_batch: np.ndarray) -> None:
        """Show each of a batch's (n, H, W, 2) flows under its pair's first
        frame of ``rgb_batch`` (:meth:`show_flow`)."""
        for i, flow in enumerate(flows):
            self.show_flow(i, flow_overlay(rgb_batch[i], flow))

    def show_flow(self, i: int, bgr: np.ndarray) -> None:
        """One overlay in a cv2 window, waiting for a key; without a
        display, ``{tmp_path}/flow_pred_{i}.png``."""
        import cv2
        try:
            cv2.imshow("Press any key to see the next frame...", bgr)
            cv2.waitKey()
        except cv2.error:
            out = Path(self.tmp_path) / f"flow_pred_{i}.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(out), (bgr * 255).astype(np.uint8))
            print(f"show_pred: no display; wrote {out}")
