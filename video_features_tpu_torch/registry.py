"""feature_type -> extractor class, for every family of the JAX package,
and the comma list of a multi-family run (``parse_feature_types``)."""
from __future__ import annotations

import importlib
from typing import List, Type

_DISPATCH = {"i3d": ("i3d", "ExtractI3D"), "raft": ("raft", "ExtractRAFT"),
             "pwc": ("pwc", "ExtractPWC"), "r21d": ("r21d", "ExtractR21D"),
             "s3d": ("s3d", "ExtractS3D"),
             "resnet": ("resnet", "ExtractResNet"),
             "clip": ("clip", "ExtractCLIP"),
             "vggish": ("vggish", "ExtractVGGish")}

#: families that consume the audio track: in a multi-family run they share
#: one wav rip per video instead of subscribing to the frame bus
AUDIO_FAMILIES = frozenset({"vggish"})


def parse_feature_types(feature_type: str) -> List[str]:
    """``'resnet,clip,s3d'`` -> ``['resnet', 'clip', 's3d']``; a single name
    is a one-element list. Every name must be registered and appear once
    (two runs of one family would race on the same output files)."""
    fams = [f.strip() for f in str(feature_type).split(",") if f.strip()]
    if not fams:
        raise NotImplementedError(f"Unknown feature_type: {feature_type!r}")
    seen = set()
    for f in fams:
        if f not in _DISPATCH:
            raise NotImplementedError(f"Unknown feature_type: {f!r}")
        if f in seen:
            raise ValueError(
                f"feature_type={feature_type!r}: family {f!r} is listed "
                "twice (its outputs would race on the same files)")
        seen.add(f)
    return fams


def get_extractor_cls(feature_type: str) -> Type:
    if feature_type not in _DISPATCH:
        raise NotImplementedError(f"Unknown feature_type: {feature_type}")
    module_name, cls_name = _DISPATCH[feature_type]
    module = importlib.import_module(f"{__package__}.extractors.{module_name}")
    return getattr(module, cls_name)
