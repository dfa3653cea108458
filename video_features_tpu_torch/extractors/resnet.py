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

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models import resnet as resnet_model
from ..models.common import Consts, cast_floating_
from ..ops import host_transforms as ht
from ..ops import preprocess as pp
from ..parallel.mesh import DataParallelApply, Mesh
from ..utils.labels import show_predictions_on_dataset
from ..weights.store import resolve_params
from .frame_wise import FrameWiseExtractor

SEED_RESNET = 5


class ExtractResNet(FrameWiseExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        if self.model_name not in resnet_model.VARIANTS:
            raise NotImplementedError(f"Model {self.model_name} not found.")
        model = resolve_params(resnet_model.ResNet(self.model_name),
                               self.model_name, args.get("weights_path"),
                               self.allow_random, SEED_RESNET)
        # the head stays float32 on the host (show_pred)
        self.head = torch.nn.Linear(model.fc.in_features,
                                    model.fc.out_features)
        self.head.load_state_dict(model.fc.state_dict())
        self.model = cast_floating_(model, self.dtype).eval()
        net = nn.ModuleDict({"model": self.model, "norm": Consts(
            mean=pp.IMAGENET_MEAN, std=pp.IMAGENET_STD)})
        self.runner = DataParallelApply(self._device_forward, net,
                                        self._data_mesh())
        self.resize_spec = (256, "bilinear")
        self.crop_size = 224
        self.host_transform = ht.ResizeCropTransform(256, 224, "bilinear",
                                                     self.ingest)

    def backbone_forward(self, net: nn.ModuleDict,
                         x: torch.Tensor) -> torch.Tensor:
        x = (x.float() / 255.0 - net["norm"].mean) / net["norm"].std
        return net["model"](x.to(self.dtype)).float()

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        if not self.show_pred:
            return
        with torch.inference_mode():
            logits = self.head(torch.from_numpy(feats)).numpy()
        show_predictions_on_dataset(logits, "imagenet")
