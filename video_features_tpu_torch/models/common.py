"""Shared building blocks (port of ``video_features_tpu/models/common.py``)."""
from __future__ import annotations

import torch
from torch import nn


class BNInf(nn.Module):
    """Inference-mode batch norm over channel dim 1:
    ``x * scale + (bias - mean * scale)`` with ``scale = weight /
    sqrt(var + eps)``, the JAX ``BNInf`` arithmetic.

    Parameter and buffer names are those of ``torch.nn.BatchNorm{2,3}d``
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so reference checkpoints load with
    ``load_state_dict``."""

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(shape) + shift.view(shape)
