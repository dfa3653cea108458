"""Reading a torch checkpoint file (port of
``video_features_tpu/weights/torch_import.py``).

The port loads the reference's checkpoints in their own key layout, so it
needs no layout conversion (the JAX package's ``conv2d_kernel`` and the
rest): only the container unwrapping and TorchScript's unwrap.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Undo ``torch.nn.DataParallel``'s ``module.`` prefix (reference
    utils/utils.py:232-238)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file's state dict on the CPU: ``torch.load`` (weights
    only), or for a TorchScript archive, which it refuses (OpenAI ships
    CLIP as ``.pt`` JIT archives; reference clip.py:128-139),
    ``torch.jit.load(...).state_dict()``; common containers
    (``state_dict``, ``model_state_dict``, ``model``) unwrapped, a
    ``module.`` prefix dropped, float16 tensors upcast to float32."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except RuntimeError:  # a TorchScript archive
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict", "model"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    return {k: (v.float() if torch.is_tensor(v) and v.dtype == torch.float16
                else v) for k, v in strip_module_prefix(obj).items()}
