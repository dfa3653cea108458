"""R(2+1)D clip-stack extractor (port of
``video_features_tpu/extractors/r21d.py``, reference
models/r21d/extract_r21d.py).

Three model flavours with their own default stack and step (16, 32, 8).
Host: [0, 1] float -> bilinear resize to 128x171 (no antialias) -> centre
crop 112 -> wire. Card: ``/255`` for the uint8 wire (or the I420 decode for
``ingest=yuv420``), the K400 normalisation in the batch's float32, the cast
to the working dtype, the backbone. ``show_pred`` runs the Kinetics-400
``fc`` head in float32 on the features, as the JAX package does. Output
key: ``['r21d']``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..models import r21d as r21d_model
from ..models.common import cast_floating_
from ..ops import colorspace
from ..ops import host_transforms as ht
from ..runner import Runner
from ..utils.labels import show_predictions_on_kinetics
from .base import load_weights
from .clip_stack import ClipStackExtractor

SEED_R21D = 3


class ExtractR21D(ClipStackExtractor):

    def __init__(self, args: Config) -> None:
        if args.get("model_name") not in r21d_model.VARIANTS:
            raise NotImplementedError(
                f"Model {args.get('model_name')} not found.")
        _, default_stack = r21d_model.VARIANTS[args.model_name]
        super().__init__(args, default_stack=default_stack,
                         default_step=default_stack)
        model = load_weights(r21d_model.R2Plus1D(self.model_name),
                             args.get("weights_path"), self.allow_random,
                             SEED_R21D, self.model_name)
        # the head stays float32 on the host (show_pred)
        self.head = torch.nn.Linear(r21d_model.FEATURE_DIM,
                                    model.fc.out_features)
        self.head.load_state_dict(model.fc.state_dict())
        self.model = cast_floating_(model, self.dtype).to(self.device).eval()
        self.mean = torch.tensor(r21d_model.R21D_MEAN, device=self.device)
        self.std = torch.tensor(r21d_model.R21D_STD, device=self.device)
        self.host_transform = ht.R21DTransform(self.ingest)
        self.runner = Runner(self._device_forward, self.device)

    def _device_forward(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, T, 112, 112, 3) float [0, 1] or uint8, or (B, T, 18816)
        packed I420 -> (B, 512) float32."""
        if self.ingest == "yuv420":
            batch = colorspace.yuv420_packed_to_rgb(batch, 112, 112) / 255.0
        elif batch.dtype == torch.uint8:
            batch = batch.float() / 255.0
        x = (batch - self.mean) / self.std
        return self.model(x.to(self.dtype)).float()

    def maybe_show_pred(self, feats: np.ndarray, windows,
                        group: np.ndarray) -> None:
        if not self.show_pred:
            return
        with torch.inference_mode():
            logits = self.head(torch.from_numpy(feats)).numpy()
        for row, (s, e) in zip(logits, windows):
            print(f"At frames ({s}, {e})")
            show_predictions_on_kinetics(row[None])
