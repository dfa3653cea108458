"""Clip-stack extraction pipeline for R(2+1)D and S3D (port of
``video_features_tpu/extractors/clip_stack.py``).

Host: decode (RGB) -> the family's per-frame transform (resize, crop,
wire format: float32 (H, W, 3), uint8 (H, W, 3) or packed I420
(H*W*3/2,) under ``ingest``) -> ``form_slices`` windows (a trailing
partial stack is dropped, reference utils/utils.py:59-68). Card: the
windows of ``clip_batch_size`` clips go over in one copy and one forward;
the last group may be short. Only the (G, D) features come back.

``extract(video_path)`` decodes with the transform on the decode-ahead
thread; ``extract_frames(frames, fps)`` takes any iterable of
``(frame_rgb_u8, t, idx)`` and applies the transform itself. Output key:
``[feature_type]``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from ..config import Config
from ..runner import Runner
from ..utils.io import Prefetcher
from ..utils.lists import form_slices
from .base import BaseExtractor


class ClipStackExtractor(BaseExtractor):
    """Families set ``host_transform``, ``runner`` and ``maybe_show_pred``.

    ``ingest`` is the host-to-device wire format: ``float32`` (the default
    in float32), ``uint8`` (the default in bfloat16: quantisation noise of
    at most 1/510, below bfloat16's input rounding) or ``yuv420`` (packed
    I420, 1.5 bytes a pixel, colour conversion on the card)."""

    supported_ingest = ("yuv420", "uint8", "float32")

    def __init__(self, args: Config, default_stack: int,
                 default_step: int) -> None:
        super().__init__(args)
        self.model_name = args.get("model_name")
        self.stack_size = args.get("stack_size") or default_stack
        self.step_size = args.get("step_size") or default_step
        self.extraction_fps = args.get("extraction_fps")
        self.clip_batch_size = int(args.get("clip_batch_size") or 8)
        self.show_pred = bool(args.get("show_pred", False))
        self.output_feat_keys = [self.feature_type]
        ingest = args.get("ingest") or (
            "uint8" if self.precision == "bfloat16" else "float32")
        if ingest not in self.supported_ingest:
            raise NotImplementedError(
                f"ingest={ingest!r}; {type(self).__name__} supports "
                f"{self.supported_ingest}")
        self.ingest = ingest
        self.host_transform = None
        self.runner: Runner = None

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        src = self.video_source(video_path, fps=self.extraction_fps,
                                transform=self.host_transform)
        return self._features(Prefetcher(src.frames()))

    def extract_frames(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                       fps: float) -> Dict[str, np.ndarray]:
        """Features of a decoded frame stream: ``frames`` yields
        ``(frame_rgb_u8 (H, W, 3), t, idx)``. ``fps`` is the stream's rate
        (the clip-stack families output no timestamps)."""
        return self._features((self.host_transform(f), t, i)
                              for f, t, i in frames)

    def _iter_stacks(self, frames: Iterable[Tuple[np.ndarray, float, int]]
                     ) -> Iterator[Tuple[Tuple[int, int], np.ndarray]]:
        """Yield ``((start, end), (stack, *frame_wire_shape))`` windows
        under the ``form_slices`` contract:

          - ``step >= stack``: disjoint windows formed as frames arrive;
            the frames between windows are dropped as they are decoded, so
            host memory stays one window;
          - ``step < stack``: every frame is in several windows, so the
            frame sequence is kept and the windows sliced from it."""
        if self.step_size < self.stack_size:
            kept = [f for f, _, _ in frames]
            if not kept:
                return
            seq = np.stack(kept)
            for s, e in form_slices(len(kept), self.stack_size,
                                    self.step_size):
                yield (s, e), seq[s:e]
            return
        gap = self.step_size - self.stack_size
        current: List[np.ndarray] = []
        start_idx = 0
        until_next = 0  # frames to drop before the next window starts
        for f, _, idx in frames:
            if until_next > 0:
                until_next -= 1
                continue
            if not current:
                start_idx = idx
            current.append(f)
            if len(current) == self.stack_size:
                yield (start_idx, start_idx + self.stack_size), \
                    np.stack(current)
                current.clear()
                until_next = gap

    def _features(self, frames: Iterable[Tuple[np.ndarray, float, int]]
                  ) -> Dict[str, np.ndarray]:
        feats: List[np.ndarray] = []
        stacks: List[np.ndarray] = []
        windows: List[Tuple[int, int]] = []

        def flush():
            group = np.stack(stacks)
            out = self.runner(group)
            self.maybe_show_pred(out, list(windows), group)
            feats.extend(list(out))
            stacks.clear()
            windows.clear()

        for window, stack in self._iter_stacks(frames):
            windows.append(window)
            stacks.append(stack)
            if len(stacks) == self.clip_batch_size:
                flush()
        if stacks:
            flush()
        return {self.feature_type: np.array(feats)}

    def maybe_show_pred(self, feats: np.ndarray, windows,
                        group: np.ndarray) -> None:
        pass
