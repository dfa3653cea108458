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

Stacks group into ``clip_batch_size`` batches, each split over the data
mesh (``parallel/mesh.py`` ``DataParallelApply``): a replica holds both
streams whole (the flow net and both I3Ds), so the flow->I3D handoff stays
on its card. A group's share crosses to its card once as uint8; under
``resize=device`` it is resized there (PIL's coefficients as two matmuls),
both streams run on the device, and only the (G, S, 1024) features come
back, through the video's ``FeatureStream``.

``extract(video_path)`` decodes, with the host transform as the source's
transform (as the JAX extractor passes it), and ``extract_frames(frames,
fps)`` takes any iterable of decoded ``(frame_rgb_u8, t, idx)`` and applies
the transform itself. As in JAX, no backbone seam is tapped here: the
RAFT flow stays on the card, and tapping it would add a copy off the card.

``show_pred`` runs each stream's I3D a second time with ``features=False``
on the same input (the flow stream on the same quantised crops, so the
flow net runs once a group), the group synchronously, and prints ``At stack
{n} ({stream} stream)`` and the Kinetics-400 top-5 for each stack, stream by
stream (extract_i3d.py:140-169).

Output keys: ``streams + [fps, timestamps_ms]``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models import i3d as i3d_model
from ..models.common import cast_floating_
from ..ops import host_transforms as ht
from ..parallel.mesh import DataParallelApply, Mesh
from ..utils.io import Prefetcher
from ..utils.labels import show_predictions_on_dataset
from ..weights.store import resolve_params
from .base import BaseExtractor
from .i3d_flow import FlowStream, i3d_heads

SEED_I3D_RGB = 0


class ExtractI3D(BaseExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
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

        mesh = self._data_mesh()
        nets = {}
        self.rgb_model = None
        if "rgb" in self.streams:
            rgb = resolve_params(
                i3d_model.I3D(400, in_channels=3), "i3d_rgb",
                args.get("weights_path"), self.allow_random, SEED_I3D_RGB)
            self.rgb_model = nets["rgb"] = cast_floating_(
                rgb, self.dtype).eval()
        self.flow_stream = None
        if "flow" in self.streams:
            self.flow_stream = nets["flow"] = FlowStream(
                self, args, mesh.data_devices[0])
        self.resize_mode = self._resolve_resize_mode(args)
        self._host_resize_for_show_pred()
        self.host_transform = None if self.resize_mode == "device" \
            else ht.EdgeResize(self.min_side_size)
        self.runner = DataParallelApply(self._forward_group,
                                        nn.ModuleDict(nets), mesh)

    def _resizer(self, in_h: int, in_w: int, device: torch.device):
        return self._edge_resizer(in_h, in_w, self.min_side_size, device)

    def _rgb(self, model: i3d_model.I3D, group: torch.Tensor) -> torch.Tensor:
        """Centre crop (TensorCenterCrop floor rule), drop the +1 frame the
        flow stream needs (extract_i3d.py:158-159), rgb I3D."""
        c = self.central_crop_size
        i = (group.shape[2] - c) // 2
        j = (group.shape[3] - c) // 2
        return i3d_heads(model, group[:, :-1, i:i + c, j:j + c], self.dtype,
                         self.show_pred)

    def _forward_group(self, net: nn.ModuleDict,
                       group: torch.Tensor) -> torch.Tensor:
        """(G, T+1, H, W, 3) uint8 on ``net``'s device -> (G, S, 1024), or
        under ``show_pred`` (G, S, 1424) with each stream's logits after its
        features."""
        if self.resize_mode == "device":
            group = self._resizer(group.shape[2], group.shape[3],
                                  group.device)(group)
        return torch.stack([self._rgb(net["rgb"], group) if s == "rgb"
                            else net["flow"](group, self.show_pred)
                            for s in self.streams], dim=1)

    def maybe_show_pred(self, out: np.ndarray, stack_base: int) -> None:
        """Print each stack's top-5 from a group's (G, S, 1424) output,
        stream by stream; ``stack_base`` is the stacks before the group, so
        both streams print the same indices (extract_i3d.py:140)."""
        for s, stream in enumerate(self.streams):
            for i, row in enumerate(out[:, s, i3d_model.FEATURE_DIM:]):
                print(f"At stack {stack_base + i} ({stream} stream)")
                show_predictions_on_dataset(row[None], "kinetics")

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        src = self.video_source(video_path, fps=self.extraction_fps,
                                transform=self.host_transform)
        # decode-ahead about one stack while the previous group computes
        frames = Prefetcher(src.frames(), depth=max(2, self.stack_size))
        return self._features(frames, src.fps)

    def extract_frames(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                       fps: float) -> Dict[str, np.ndarray]:
        """Features of a decoded frame stream: ``frames`` yields
        ``(frame_rgb_u8 (H, W, 3), t, idx)``; ``fps`` is the stream's rate,
        which sets the timestamps."""
        if self.host_transform is not None:
            tf = self.host_transform
            frames = ((tf(f), t, i) for f, t, i in frames)
        return self._features(frames, fps)

    def _features(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                  fps: float) -> Dict[str, np.ndarray]:
        window: List[np.ndarray] = []
        stacks: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        stream = self.feature_stream(self.runner,
                                     on_result=self.maybe_show_pred)
        stacks_done = 0

        def flush():
            nonlocal stacks_done
            if not stacks:
                return
            stream.submit(np.stack(stacks), ctx=stacks_done)
            stacks_done += len(stacks)
            stacks.clear()

        for frame, _, idx in frames:
            window.append(frame)
            if len(window) - 1 == self.stack_size:
                stacks.append(np.stack(window))
                timestamps_ms.append(idx / fps * 1000.0)
                window = window[self.step_size:]
                if len(stacks) == self.clip_batch_size:
                    flush()
        flush()

        groups = stream.finish()  # each (G, S, 1024), or 1424 (show_pred)
        out = {s: (np.concatenate([g[:, i, :i3d_model.FEATURE_DIM]
                                   for g in groups]) if groups
                   else np.array([]))
               for i, s in enumerate(self.streams)}
        out["fps"] = np.array(fps)
        out["timestamps_ms"] = np.array(timestamps_ms)
        return out
