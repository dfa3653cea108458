"""Single-device runner (stands in for ``parallel/mesh.py``
``DataParallelApply`` / ``FeatureStream`` of the JAX package).

One card, no mesh and no bucket padding: a batch goes to the device once,
the forward runs under ``torch.inference_mode()``, and only the small
result comes back to the host.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch


def to_device(batch: Union[np.ndarray, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """Host array or tensor -> tensor on ``device`` (one copy; pinned and
    non-blocking for a CUDA target)."""
    t = torch.from_numpy(np.ascontiguousarray(batch)) \
        if isinstance(batch, np.ndarray) else batch
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Runner:
    """``runner(batch) -> np.ndarray``: ``fn(batch_on_device)`` under
    inference mode, result brought back to the host as float32."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 device: torch.device) -> None:
        self.fn = fn
        self.device = device

    def __call__(self, batch: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
        with torch.inference_mode():
            out = self.fn(to_device(batch, self.device))
            return out.float().cpu().numpy()
