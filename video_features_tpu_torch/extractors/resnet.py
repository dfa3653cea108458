"""ResNet frame-wise extractor (port of
``video_features_tpu/extractors/resnet.py``, reference
models/resnet/extract_resnet.py).

Resize(256) bilinear -> CenterCrop(224) on the host or the card
(``frame_wise.py``); on the card: /255, the ImageNet normalisation in
float32, the cast to the working dtype, the backbone, float32 features.
``show_pred`` runs the ImageNet ``fc`` head in float32 on the host over the
ImageNet labels. Output keys: ``['resnet', 'fps', 'timestamps_ms']``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..models import resnet as resnet_model
from ..models.common import cast_floating_
from ..ops import host_transforms as ht
from ..ops import preprocess as pp
from ..utils.labels import show_predictions_on_dataset
from .base import load_weights
from .frame_wise import FrameWiseExtractor

SEED_RESNET = 5


class ExtractResNet(FrameWiseExtractor):

    def __init__(self, args: Config) -> None:
        super().__init__(args)
        if self.model_name not in resnet_model.VARIANTS:
            raise NotImplementedError(f"Model {self.model_name} not found.")
        model = load_weights(resnet_model.ResNet(self.model_name),
                             args.get("weights_path"), self.allow_random,
                             SEED_RESNET, self.model_name)
        # the head stays float32 on the host (show_pred)
        self.head = torch.nn.Linear(model.fc.in_features,
                                    model.fc.out_features)
        self.head.load_state_dict(model.fc.state_dict())
        self.model = cast_floating_(model, self.dtype).to(self.device).eval()
        self.mean = torch.from_numpy(pp.IMAGENET_MEAN).to(self.device)
        self.std = torch.from_numpy(pp.IMAGENET_STD).to(self.device)
        self.resize_spec = (256, "bilinear")
        self.crop_size = 224
        self.host_transform = ht.ResizeCropTransform(256, 224, "bilinear",
                                                     self.ingest)

    def backbone_forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.float() / 255.0 - self.mean) / self.std
        return self.model(x.to(self.dtype)).float()

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        if not self.show_pred:
            return
        with torch.inference_mode():
            logits = self.head(torch.from_numpy(feats)).numpy()
        show_predictions_on_dataset(logits, "imagenet")
