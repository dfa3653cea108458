"""Shared building blocks (port of ``video_features_tpu/models/common.py``),
the port's ``cast_floating_`` (of ``parallel/mesh.py cast_floating``) and
``Consts``, the constants that travel with a replica."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def cast_floating_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter *and buffer* of ``module`` to ``dtype``
    in place (integer buffers such as ``num_batches_tracked`` stay): the
    weights of ``precision=bfloat16``. The JAX ``BNInf`` keeps its running
    statistics as params, which ``cast_floating`` casts, so ``running_mean``
    and ``running_var`` are cast here too (``Module.to(dtype)`` casts
    exactly the floating parameters and buffers)."""
    return module.to(dtype=dtype)


class Consts(nn.Module):
    """Named float32 constants of a device path (an input normalisation's
    mean and std) as buffers, so that they travel with a replica
    (``Module.to``, ``copy.deepcopy``) and a forward reads them on its own
    device without a host copy."""

    def __init__(self, **values) -> None:
        super().__init__()
        for name, value in values.items():
            self.register_buffer(name, torch.as_tensor(value,
                                                       dtype=torch.float32))


class BNInf(nn.Module):
    """Inference-mode batch norm over channel dim 1, the JAX ``BNInf``
    arithmetic: ``inv = rsqrt(var + eps)`` in float32, cast to the
    activation dtype; then ``scale = weight * inv``,
    ``shift = bias - mean * scale`` and ``x * scale + shift``, all in the
    activation dtype (in bfloat16 the ``eps`` is not lost against a variance
    near 1). Float32 results are those of the plain formula.

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
        inv = torch.rsqrt(self.running_var.float() + self.eps).to(x.dtype)
        scale = self.weight.to(x.dtype) * inv
        shift = self.bias.to(x.dtype) - self.running_mean.to(x.dtype) * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(shape) + shift.view(shape)


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s rounding: the product rounded to
    the activation dtype, then the bias added and rounded again (bfloat16
    results follow JAX's; float32 ones are the plain formula's)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight) + self.bias


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``Conv``'s rounding, as :class:`Dense`: the
    convolution without its bias, rounded to the activation dtype, then the
    bias added."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight, None) + \
            self.bias.view(1, -1, 1, 1)
