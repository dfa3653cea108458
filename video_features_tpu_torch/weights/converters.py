"""The model keys the weights store knows, and how each key's converted
JAX tree maps onto the port's modules (port of
``video_features_tpu/weights/converters.py``).

The JAX package's registry pairs each key with its flax ``init_params``
and ``params_from_torch``; the port loads the reference's torch layout
directly, so each key here maps only the JAX package's converted
``{model_key}.msgpack`` tree (``weights/store.py``) through
``weights/bridge.py``. ``vggish_pca`` is absent in both: its two arrays
load directly (``models/vggish.py load_pca_params``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

StateFromJax = Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]


def registry() -> Dict[str, StateFromJax]:
    """Every convertible model key -> its ``*_state_from_jax``."""
    from ..extractors.clip import model_key
    from ..models import clip, r21d, resnet
    from . import bridge

    reg: Dict[str, StateFromJax] = {}
    for variant in resnet.VARIANTS:
        reg[variant] = bridge.resnet_state_from_jax
    for variant in r21d.VARIANTS:
        reg[variant] = bridge.r21d_state_from_jax
    for key in ("raft_sintel", "raft_kitti"):
        reg[key] = bridge.raft_state_from_jax
    for modality in ("rgb", "flow"):
        reg[f"i3d_{modality}"] = bridge.i3d_state_from_jax
    reg["s3d_kinetics400"] = bridge.s3d_state_from_jax
    reg["pwc_sintel"] = bridge.pwc_state_from_jax
    reg["vggish"] = bridge.vggish_state_from_jax
    for name in clip.CONFIGS:
        reg[model_key(name)] = bridge.clip_state_from_jax
    return reg
