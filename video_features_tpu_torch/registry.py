"""feature_type -> extractor class. Every family of the JAX package but
``vggish`` is ported; ``vggish`` raises ``NotImplementedError``."""
from __future__ import annotations

import importlib
from typing import Type

_DISPATCH = {"i3d": ("i3d", "ExtractI3D"), "raft": ("raft", "ExtractRAFT"),
             "pwc": ("pwc", "ExtractPWC"), "r21d": ("r21d", "ExtractR21D"),
             "s3d": ("s3d", "ExtractS3D"),
             "resnet": ("resnet", "ExtractResNet"),
             "clip": ("clip", "ExtractCLIP")}
_NOT_PORTED = ("vggish",)


def get_extractor_cls(feature_type: str) -> Type:
    if feature_type in _NOT_PORTED:
        raise NotImplementedError(
            f"feature_type={feature_type!r} is not ported to the torch "
            "package yet (ROADMAP.md Queue 1)")
    if feature_type not in _DISPATCH:
        raise NotImplementedError(f"Unknown feature_type: {feature_type}")
    module_name, cls_name = _DISPATCH[feature_type]
    module = importlib.import_module(f"{__package__}.extractors.{module_name}")
    return getattr(module, cls_name)
