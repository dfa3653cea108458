"""S3D clip-stack extractor (port of ``video_features_tpu/extractors/s3d.py``,
reference models/s3d/extract_s3d.py).

Defaults stack = step = 64 and ``extraction_fps`` 25, forced when null
(extract_s3d.py:29). Host: [0, 1] float -> bilinear resize by the scale
factor 224 / smaller edge -> centre crop 224 -> wire, no normalisation.
Card: ``/255`` for the uint8 wire (or the I420 decode for
``ingest=yuv420``), the cast to the working dtype, S3D with
``features=True``. ``show_pred`` runs the model a second time on the same
group with ``features=False`` (extract_s3d.py:95-99). Output key:
``['s3d']``.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..models import s3d as s3d_model
from ..models.common import cast_floating_
from ..ops import colorspace
from ..ops import host_transforms as ht
from ..parallel.mesh import DataParallelApply, Mesh
from ..utils.labels import show_predictions_on_dataset
from ..weights.store import resolve_params
from .clip_stack import ClipStackExtractor

SEED_S3D = 4


class ExtractS3D(ClipStackExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, default_stack=64, default_step=64, mesh=mesh)
        if self.extraction_fps is None:
            self.extraction_fps = 25  # reference extract_s3d.py:29
        model = resolve_params(s3d_model.S3D(400), "s3d_kinetics400",
                               args.get("weights_path"), self.allow_random,
                               SEED_S3D)
        self.model = cast_floating_(model, self.dtype).eval()
        self.host_transform = ht.S3DTransform(self.ingest)
        self.runner = DataParallelApply(self._device_forward, self.model,
                                        self._data_mesh())
        # show_pred's logits: the same replicas, the head instead
        self._logits_runner = self.runner.with_fn(
            partial(self._device_forward, features=False))

    def _device_forward(self, model: s3d_model.S3D, batch: torch.Tensor,
                        features: bool = True) -> torch.Tensor:
        """(B, T, 224, 224, 3) float [0, 1] or uint8, or (B, T, 75264)
        packed I420 -> (B, 1024) features or (B, 400) logits, float32."""
        if self.ingest == "yuv420":
            batch = colorspace.yuv420_packed_to_rgb(batch, 224, 224) / 255.0
        elif batch.dtype == torch.uint8:
            batch = batch.float() / 255.0
        return model(batch.to(self.dtype), features=features).float()

    def maybe_show_pred(self, feats: np.ndarray, windows,
                        group: np.ndarray) -> None:
        if not self.show_pred:
            return
        for row, (s, e) in zip(self._logits_runner(group), windows):
            print(f"At frames ({s}, {e})")
            show_predictions_on_dataset(row[None], "kinetics")
