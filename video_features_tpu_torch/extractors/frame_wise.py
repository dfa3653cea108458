"""Frame-wise extraction pipeline for ResNet and CLIP (port of
``video_features_tpu/extractors/frame_wise.py``, reference
models/_base/base_framewise_extractor.py:11-88).

One feature row per decoded frame, in batches of ``batch_size`` frames;
each batch is split over the data mesh (``parallel/mesh.py``
``DataParallelApply``), each share crosses to its card in one copy and one
forward, and only the (B, D) features come back, through the video's
``FeatureStream`` (synchronous under ``show_pred``). Two places to resize:

  - ``resize=host`` (the ``auto`` choice for ``print`` and ``show_pred``
    runs): the family's ``ResizeCropTransform`` (PIL resize of the smaller
    edge, centre crop) runs on the decode-ahead thread, and the card gets
    the crop as uint8 or, under ``ingest=yuv420``, as packed I420;
  - ``resize=device`` (the ``auto`` choice for file sinks): the host only
    decodes; raw uint8 RGB frames, or under ``ingest=yuv420`` cv2-layout
    I420 planes (H*3/2, W) converted on the card and rounded back to uint8,
    go to the card, where PIL's coefficients resize them as two matmuls
    (one resizer per source resolution and device,
    ``BaseExtractor._edge_resizer``, inside each replica's forward)
    and the centre crop takes the same window as the host crop. A source
    with odd dimensions has no I420 layout and ships RGB instead.

``extract(video_path)`` decodes; ``extract_frames(frames, fps)`` takes any
iterable of ``(frame_rgb_u8, t, idx)``. Output keys: ``[feature_type, fps,
timestamps_ms]``.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import colorspace
from ..ops import preprocess as pp
from ..parallel.mesh import DataParallelApply, Mesh
from ..utils.io import Prefetcher, _batched, get_video_props
from .base import BaseExtractor


class I420Planes:
    """RGB frame (H, W, 3) -> cv2-layout I420 planes (H*3/2, W), the bytes
    the decoder's ``channel_order='i420'`` gives for the same frame."""

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        h, w = rgb.shape[:2]
        return colorspace.rgb_to_yuv420(rgb).reshape(h * 3 // 2, w)


class FrameWiseExtractor(BaseExtractor):
    """Families set ``resize_spec`` ``(size, interpolation)``,
    ``crop_size``, ``host_transform``, ``runner`` (a ``DataParallelApply``
    of :meth:`_device_forward` over the data mesh), ``backbone_forward``
    and ``maybe_show_pred``.

    ``ingest`` is the host-to-device wire: ``uint8`` (the default, lossless:
    PIL's resize gives uint8) or ``yuv420`` (1.5 bytes a pixel, the colour
    conversion on the card)."""

    supported_ingest = ("uint8", "yuv420")

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        self.model_name = args.get("model_name")
        self.batch_size = int(args.batch_size)
        self.extraction_fps = args.get("extraction_fps")
        self.extraction_total = args.get("extraction_total")
        self.output_feat_keys = [self.feature_type, "fps", "timestamps_ms"]
        ingest = args.get("ingest") or "uint8"
        if ingest not in self.supported_ingest:
            raise NotImplementedError(
                f"ingest={ingest!r}; {type(self).__name__} supports "
                f"{self.supported_ingest}")
        self.ingest = ingest
        self.resize_mode = self._resolve_resize_mode(args)
        self.resize_spec: Tuple[int, str] = None
        self.crop_size: int = None
        self.host_transform: Optional[Callable] = None
        self.runner: DataParallelApply = None

    def backbone_forward(self, net: torch.nn.Module,
                         x: torch.Tensor) -> torch.Tensor:
        """(B, crop, crop, 3) uint8 or float in [0, 255] on ``net``'s
        device -> (B, D) float32 features."""
        raise NotImplementedError

    def _device_forward(self, net: torch.nn.Module,
                        batch: torch.Tensor) -> torch.Tensor:
        """One batch share on its replica's device, in the layout its wire
        gives it: (B, H*3/2, W) I420 planes or (B, H, W, 3) raw frames to
        resize and crop (``resize=device``), or the host's (B, c*c*3/2)
        packed I420 or (B, c, c, 3) uint8 crops."""
        c = self.crop_size
        if self.resize_mode == "device":
            if batch.dim() == 3:
                batch = colorspace.yuv420_frame_to_rgb_u8(
                    batch, batch.shape[1] * 2 // 3, batch.shape[2])
            h, w = batch.shape[1:3]
            size, interpolation = self.resize_spec
            batch = self._edge_resizer(h, w, size, batch.device,
                                       interpolation=interpolation)(batch)
            i, j = pp.center_crop_offsets(batch.shape[1], batch.shape[2], c,
                                          c)
            batch = batch[:, i:i + c, j:j + c]
        elif batch.dim() == 2:
            batch = colorspace.yuv420_packed_to_rgb(batch, c, c)
        return self.backbone_forward(net, batch)

    def _raw_wire(self, h: int, w: int, what: str) -> str:
        """``resize=device``'s wire for a source of ``h`` x ``w``: ``i420``
        under ``ingest=yuv420`` where the dimensions are even, else ``rgb``
        (with a warning for the odd source)."""
        if self.ingest != "yuv420":
            return "rgb"
        if h % 2 or w % 2:
            print(f"WARNING: {what} has odd dimensions {h}x{w}; I420 needs "
                  "even dims -- shipping raw RGB for this video instead")
            return "rgb"
        return "i420"

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        order = "rgb"
        if self.resize_mode == "device":
            props = get_video_props(video_path)
            order = self._raw_wire(props["height"], props["width"],
                                   video_path)
        src = self.video_source(
            video_path, fps=self.extraction_fps, total=self.extraction_total,
            batch_size=self.batch_size, channel_order=order,
            transform=(None if self.resize_mode == "device"
                       else self.host_transform))
        return self._features(Prefetcher(src), src.fps, video_path)

    def extract_frames(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                       fps: float) -> Dict[str, np.ndarray]:
        """Features of a decoded frame stream: ``frames`` yields
        ``(frame_rgb_u8 (H, W, 3), t, idx)``; ``t`` is each frame's
        timestamp, ``fps`` the stream's rate. The frames go through the
        host transform (``resize=host``) or onto the raw wire
        (``resize=device``: as they are, or packed into cv2's I420 layout
        under ``ingest=yuv420``)."""
        frames = iter(frames)
        first = next(frames, None)
        if first is None:
            return self._features([], fps)
        stream = itertools.chain([first], frames)
        wire = self.host_transform
        if self.resize_mode == "device":
            h, w = first[0].shape[:2]
            wire = (I420Planes() if self._raw_wire(h, w, "the frame stream")
                    == "i420" else None)
        if wire is not None:
            stream = ((wire(f), t, i) for f, t, i in stream)
        return self._features(_batched(stream, self.batch_size, 0), fps)

    def _features(self, batches: Iterable[Tuple[List, List[float], List]],
                  fps: float, video: Optional[str] = None
                  ) -> Dict[str, np.ndarray]:
        """With ``parity=true`` and a ``video``, each batch's activations as
        they came off the card are the backbone seam."""
        stream = self.feature_stream(
            self.runner,
            on_result=lambda feats, _: self.maybe_show_pred(feats))
        timestamps_ms: List[float] = []
        for batch, times, _ in batches:
            stream.submit(np.stack(batch))
            timestamps_ms.extend(times)
        outs = stream.finish()
        self.tap_backbone(outs, video)
        feats = [row for out in outs for row in out]
        return {self.feature_type: np.array(feats), "fps": np.array(fps),
                "timestamps_ms": np.array(timestamps_ms)}

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        pass
