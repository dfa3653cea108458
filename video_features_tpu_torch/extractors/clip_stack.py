"""Clip-stack extraction pipeline for R(2+1)D and S3D (port of
``video_features_tpu/extractors/clip_stack.py``).

Host: decode (RGB) -> the family's per-frame transform (resize, crop,
wire format: float32 (H, W, 3), uint8 (H, W, 3) or packed I420
(H*W*3/2,) under ``ingest``) -> ``form_slices`` windows (a trailing
partial stack is dropped, reference utils/utils.py:59-68). Card: the
windows of ``clip_batch_size`` clips go over in one copy and one forward;
the last group may be short. Only the (G, D) features come back.

Each video's groups go through its own ``FeatureStream`` (the forward of
one group overlaps the decode and transform of the next; synchronous under
``show_pred``). ``cross_video_batching=true`` sends the clips instead into
one ``ClipPacker`` shared by the ``video_workers`` threads, whose groups go
out full (``parallel/packer.py``). Both run over the data mesh.

``extract(video_path)`` decodes with the transform on the decode-ahead
thread; ``extract_frames(frames, fps)`` takes any iterable of
``(frame_rgb_u8, t, idx)`` and applies the transform itself. Output key:
``[feature_type]``.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..parallel.mesh import DataParallelApply, Mesh
from ..parallel.packer import ClipPacker
from ..utils.io import Prefetcher
from ..utils.lists import form_slices
from .base import BaseExtractor


class ClipStackExtractor(BaseExtractor):
    """Families set ``host_transform``, ``runner`` (a
    ``DataParallelApply`` over :meth:`_data_mesh`) and ``maybe_show_pred``.

    ``ingest`` is the host-to-device wire format: ``float32`` (the default
    in float32), ``uint8`` (the default in bfloat16: quantisation noise of
    at most 1/510, below bfloat16's input rounding) or ``yuv420`` (packed
    I420, 1.5 bytes a pixel, colour conversion on the card)."""

    supported_ingest = ("yuv420", "uint8", "float32")

    def __init__(self, args: Config, default_stack: int, default_step: int,
                 mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        self.model_name = args.get("model_name")
        self.stack_size = args.get("stack_size") or default_stack
        self.step_size = args.get("step_size") or default_step
        self.extraction_fps = args.get("extraction_fps")
        self.clip_batch_size = int(args.get("clip_batch_size") or 8)
        self.output_feat_keys = [self.feature_type]
        ingest = args.get("ingest") or (
            "uint8" if self.precision == "bfloat16" else "float32")
        if ingest not in self.supported_ingest:
            raise NotImplementedError(
                f"ingest={ingest!r}; {type(self).__name__} supports "
                f"{self.supported_ingest}")
        self.ingest = ingest
        self.host_transform = None
        self.runner: DataParallelApply = None
        self.cross_video = bool(args.get("cross_video_batching", False))
        if self.cross_video and self.show_pred:
            raise NotImplementedError(
                "cross_video_batching=true is incompatible with "
                "show_pred=true (predictions print per video group; packed "
                "groups interleave videos)")
        self._packer: Optional[ClipPacker] = None
        self._packer_lock = threading.Lock()

    def _get_packer(self) -> ClipPacker:
        with self._packer_lock:
            if self._packer is None:
                self._packer = ClipPacker(self.runner,
                                          batch=self.clip_batch_size)
            return self._packer

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        src = self.video_source(video_path, fps=self.extraction_fps,
                                transform=self.host_transform)
        return self._features(Prefetcher(src.frames()), video_path)

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

    def _features(self, frames: Iterable[Tuple[np.ndarray, float, int]],
                  video: Optional[str] = None) -> Dict[str, np.ndarray]:
        """With ``parity=true`` and a ``video``, the clips' activations as
        they came off the card are the backbone seam: one record per group,
        or one for the video's packed clips."""
        if self.cross_video:
            return self._features_packed(frames, video)
        return self._features_grouped(frames, video)

    def _features_grouped(self, frames: Iterable[Tuple[np.ndarray, float,
                                                        int]],
                          video: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
        """Groups of ``clip_batch_size`` windows through this video's
        stream; the last group may be short."""
        stream = self.feature_stream(
            self.runner,
            on_result=lambda feats, ctx: self.maybe_show_pred(feats, *ctx))
        stacks: List[np.ndarray] = []
        windows: List[Tuple[int, int]] = []

        def flush():
            group = np.stack(stacks)
            stream.submit(group, ctx=(list(windows), group))
            stacks.clear()
            windows.clear()

        for window, stack in self._iter_stacks(frames):
            windows.append(window)
            stacks.append(stack)
            if len(stacks) == self.clip_batch_size:
                flush()
        if stacks:
            flush()
        outs = stream.finish()
        self.tap_backbone(outs, video)
        feats = [row for out in outs for row in out]
        return {self.feature_type: np.array(feats)}

    def _features_packed(self, frames: Iterable[Tuple[np.ndarray, float,
                                                       int]],
                         video: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
        """The clips into the shared packer; they come back per video in
        clip order. A failure aborts the video's handle, so that it cannot
        wedge the other workers' closes."""
        packer = self._get_packer()
        handle = packer.open_video()
        try:
            for _, stack in self._iter_stacks(frames):
                packer.add(handle, stack)
        except BaseException:
            packer.abort_video(handle)
            raise
        feats = packer.close_video(handle)
        self.tap_backbone([feats], video)
        return {self.feature_type: feats}

    def maybe_show_pred(self, feats: np.ndarray, windows,
                        group: np.ndarray) -> None:
        pass
