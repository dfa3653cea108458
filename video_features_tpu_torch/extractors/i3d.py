"""I3D two-stream extractor (port of ``video_features_tpu/extractors/i3d.py``).

Reference models/i3d/extract_i3d.py: accumulate ``stack_size + 1`` frames
resized to 256 on the smaller edge (N+1 frames -> N flow frames; the rgb
stream uses ``stack[:-1]`` so both streams have equal length), run each
stream's I3D on centre-cropped 224 inputs scaled to [-1, 1], and record one
``timestamps_ms`` per completed stack, ``last_idx / fps * 1000`` (the pts of
the frame just decoded, extract_i3d.py:122).

The flow stream runs ``flow_type=pwc`` (the YAML default) or ``raft``
(``extractors/i3d_flow.py``). ``precision=bfloat16`` casts both streams'
I3D weights (``cast_floating_``) and their inputs before ScaleTo1_1; the
features come back float32.

Stacks group into ``clip_batch_size`` batches. A group crosses to the card
once as uint8; under ``resize=device`` it is resized there (PIL's
coefficients as two matmuls), both streams run on the device, and only the
(G, 1024) features come back.

``extract(video_path)`` decodes and hands the frames to
``extract_frames(frames, fps)``, which takes any iterable of
``(frame_rgb_u8, t, idx)``.

Output keys: ``streams + [fps, timestamps_ms]``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..models import i3d as i3d_model
from ..models.common import cast_floating_
from ..ops import host_transforms as ht
from ..runner import Runner
from ..utils.io import Prefetcher
from .base import BaseExtractor, load_weights
from .i3d_flow import FlowStream, i3d_forward

SEED_I3D_RGB = 0


class ExtractI3D(BaseExtractor):

    def __init__(self, args: Config) -> None:
        super().__init__(args)
        streams = args.get("streams")
        self.streams: List[str] = (["rgb", "flow"] if streams is None
                                   else [streams])
        for stream in self.streams:
            if stream not in ("rgb", "flow"):
                raise NotImplementedError(f"Unknown I3D stream: {stream}")
        self.flow_type = args.get("flow_type", "pwc")  # reference default
        self.min_side_size = 256
        self.central_crop_size = 224
        self.extraction_fps = args.get("extraction_fps")
        self.stack_size = args.get("stack_size") or 64
        self.step_size = args.get("step_size") or 64
        self.clip_batch_size = int(args.get("clip_batch_size") or 8)
        self.output_feat_keys = self.streams + ["fps", "timestamps_ms"]

        self.rgb_model = None
        if "rgb" in self.streams:
            rgb = load_weights(
                i3d_model.I3D(400, in_channels=3), args.get("weights_path"),
                self.allow_random, SEED_I3D_RGB, "i3d_rgb")
            self.rgb_model = cast_floating_(rgb, self.dtype).to(
                self.device).eval()
        self.flow_stream = FlowStream(self, args) \
            if "flow" in self.streams else None
        self.resize_mode = self._resolve_resize_mode(args)
        self.host_transform = None if self.resize_mode == "device" \
            else ht.EdgeResize(self.min_side_size)
        self.runner = Runner(self._forward_group, self.device)

    def _resizer(self, in_h: int, in_w: int):
        return self._edge_resizer(in_h, in_w, self.min_side_size)

    def _rgb(self, group: torch.Tensor) -> torch.Tensor:
        """Centre crop (TensorCenterCrop floor rule), drop the +1 frame the
        flow stream needs (extract_i3d.py:158-159), rgb I3D."""
        c = self.central_crop_size
        i = (group.shape[2] - c) // 2
        j = (group.shape[3] - c) // 2
        return i3d_forward(self.rgb_model,
                           group[:, :-1, i:i + c, j:j + c], self.dtype)

    def _forward_group(self, group: torch.Tensor) -> torch.Tensor:
        """(G, T+1, H, W, 3) uint8 on the device -> (S, G, 1024)."""
        if self.resize_mode == "device":
            group = self._resizer(group.shape[2], group.shape[3])(group)
        return torch.stack([self._rgb(group) if s == "rgb"
                            else self.flow_stream(group)
                            for s in self.streams])

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        src = self.video_source(video_path, fps=self.extraction_fps)
        # decode-ahead about one stack while the previous group computes
        frames = Prefetcher(src.frames(), depth=max(2, self.stack_size))
        return self.extract_frames(frames, src.fps)

    def extract_frames(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                       fps: float) -> Dict[str, np.ndarray]:
        """Features of a decoded frame stream: ``frames`` yields
        ``(frame_rgb_u8 (H, W, 3), t, idx)``; ``fps`` is the stream's rate,
        which sets the timestamps."""
        window: List[np.ndarray] = []
        stacks: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        feats: Dict[str, List[np.ndarray]] = {s: [] for s in self.streams}

        def flush():
            if not stacks:
                return
            out = self.runner(np.stack(stacks))  # (S, G, 1024)
            stacks.clear()
            for s, rows in zip(self.streams, out):
                feats[s].extend(list(rows))

        for frame, _, idx in frames:
            if self.host_transform is not None:
                frame = self.host_transform(frame)
            window.append(frame)
            if len(window) - 1 == self.stack_size:
                stacks.append(np.stack(window))
                timestamps_ms.append(idx / fps * 1000.0)
                window = window[self.step_size:]
                if len(stacks) == self.clip_batch_size:
                    flush()
        flush()

        out = {s: np.array(v) for s, v in feats.items()}
        out["fps"] = np.array(fps)
        out["timestamps_ms"] = np.array(timestamps_ms)
        return out
