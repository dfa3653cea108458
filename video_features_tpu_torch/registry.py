"""feature_type -> extractor class, for every family of the JAX package."""
from __future__ import annotations

import importlib
from typing import Type

_DISPATCH = {"i3d": ("i3d", "ExtractI3D"), "raft": ("raft", "ExtractRAFT"),
             "pwc": ("pwc", "ExtractPWC"), "r21d": ("r21d", "ExtractR21D"),
             "s3d": ("s3d", "ExtractS3D"),
             "resnet": ("resnet", "ExtractResNet"),
             "clip": ("clip", "ExtractCLIP"),
             "vggish": ("vggish", "ExtractVGGish")}


def get_extractor_cls(feature_type: str) -> Type:
    if feature_type not in _DISPATCH:
        raise NotImplementedError(f"Unknown feature_type: {feature_type}")
    module_name, cls_name = _DISPATCH[feature_type]
    module = importlib.import_module(f"{__package__}.extractors.{module_name}")
    return getattr(module, cls_name)
