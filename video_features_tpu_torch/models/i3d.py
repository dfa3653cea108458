"""I3D (Inception-v1 inflated to 3D, Kinetics-400) in PyTorch.

Port of ``video_features_tpu/models/i3d.py`` (reference
models/i3d/i3d_src/i3d_net.py, the hassony2 port of DeepMind's weights):
``Unit3D`` = Conv3d + BN + ReLU with the reference's input-size-independent
"TF SAME" padding, ``MaxPool3dTFPadding`` = explicit zero padding then a
ceil-mode max pool, nine ``Mixed`` blocks and the ``(2, 7, 7)`` average-pool
head. The dense convolutions stay cuDNN through ``F.conv3d``: no Pallas
kernel computes them in the JAX package either.

Public layout is the JAX one: ``(N, T, 224, 224, C)`` in [-1, 1] ->
``(N, 1024)`` features or ``(N, num_classes)`` logits, in the input's
dtype (``precision=bfloat16`` feeds bfloat16 inputs to cast weights,
``cast_floating_``). Module names follow the reference's keys
(``mixed_3b.branch_1.0.conv3d.weight``,
``conv3d_1a_7x7.batch3d.running_mean``), so ``i3d_rgb.pt`` /
``i3d_flow.pt`` load with ``load_state_dict``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BNInf

FEATURE_DIM = 1024


def tf_same_pads(kernel: Sequence[int],
                 stride: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Reference ``get_padding_shape`` (i3d_net.py:8-25) as (lo, hi) pairs
    in (T, H, W) order: ``pad_along = max(k - s, 0)``."""
    out = []
    for k, s in zip(kernel, stride):
        pad_along = max(k - s, 0)
        lo = pad_along // 2
        out.append((lo, pad_along - lo))
    return tuple(out)


def _pad_arg(pads: Tuple[Tuple[int, int], ...]) -> Tuple[int, ...]:
    """(T, H, W) (lo, hi) pairs -> F.pad's last-dim-first flat tuple."""
    (tl, th), (hl, hh), (wl, wh) = pads
    return (wl, wh, hl, hh, tl, th)


def max_pool_tf_ceil(x: torch.Tensor, window: Sequence[int],
                     strides: Sequence[int]) -> torch.Tensor:
    """MaxPool3dTFPadding (i3d_net.py:108-120) on NCDHW: explicit zero
    padding (padded zeros take part in the max), then a ceil-mode max pool
    whose overhang cells never win."""
    x = F.pad(x, _pad_arg(tf_same_pads(window, strides)))
    return F.max_pool3d(x, tuple(window), tuple(strides), ceil_mode=True)


def window_mean(x: torch.Tensor) -> torch.Tensor:
    """AvgPool3d((2, 7, 7), stride 1) on NCDHW as the JAX ``reduce_window``
    computes it: the 98 window terms added one at a time in the activation
    dtype, in window order (t, then h, then w), then divided by 98. In
    bfloat16 each partial sum rounds, as in the JAX package's jitted CPU
    run; ``F.avg_pool3d`` would sum in float32 (and has no bfloat16 CPU
    kernel)."""
    t, h, w = x.shape[2:]
    acc = torch.zeros_like(x[:, :, :t - 1, :h - 6, :w - 6])
    for dt in range(2):
        for dh in range(7):
            for dw in range(7):
                acc = acc + x[:, :, dt:dt + t - 1, dh:dh + h - 6,
                              dw:dw + w - 6]
    return acc / 98


class Unit3D(nn.Module):
    """Conv3d + (BN) + (ReLU) with the reference's SAME padding rule;
    ``conv3d`` / ``batch3d`` are the reference's ``Unit3Dpy`` names."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 use_bias: bool = False, use_bn: bool = True,
                 relu: bool = True) -> None:
        super().__init__()
        self.pad = _pad_arg(tf_same_pads(kernel, stride))
        self.conv3d = nn.Conv3d(in_channels, out_channels, kernel, stride,
                                bias=use_bias)
        self.batch3d = BNInf(out_channels) if use_bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(F.pad(x, self.pad))
        if self.batch3d is not None:
            x = self.batch3d(x)
        return F.relu(x) if self.relu else x


class _MaxPoolTF(nn.Module):
    """Parameter-free module form of :func:`max_pool_tf_ceil` (index 0 of
    the reference's ``branch_3`` Sequential)."""

    def __init__(self, window, strides) -> None:
        super().__init__()
        self.window, self.strides = window, strides

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_tf_ceil(x, self.window, self.strides)


class Mixed(nn.Module):
    """Inception block (i3d_net.py:123-157); channels
    ``(b0, b1 reduce, b1 out, b2 reduce, b2 out, b3 proj)``."""

    def __init__(self, in_channels: int,
                 channels: Tuple[int, int, int, int, int, int]) -> None:
        super().__init__()
        b0c, b1r, b1c, b2r, b2c, b3c = channels
        self.branch_0 = Unit3D(in_channels, b0c)
        self.branch_1 = nn.Sequential(Unit3D(in_channels, b1r),
                                      Unit3D(b1r, b1c, (3, 3, 3)))
        self.branch_2 = nn.Sequential(Unit3D(in_channels, b2r),
                                      Unit3D(b2r, b2c, (3, 3, 3)))
        self.branch_3 = nn.Sequential(_MaxPoolTF((3, 3, 3), (1, 1, 1)),
                                      Unit3D(in_channels, b3c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch_0(x), self.branch_1(x),
                          self.branch_2(x), self.branch_3(x)], dim=1)


MIXED_CHANNELS = {
    "mixed_3b": (64, 96, 128, 16, 32, 32),
    "mixed_3c": (128, 128, 192, 32, 96, 64),
    "mixed_4b": (192, 96, 208, 16, 48, 64),
    "mixed_4c": (160, 112, 224, 24, 64, 64),
    "mixed_4d": (128, 128, 256, 24, 64, 64),
    "mixed_4e": (112, 144, 288, 32, 64, 64),
    "mixed_4f": (256, 160, 320, 32, 128, 128),
    "mixed_5b": (256, 160, 320, 32, 128, 128),
    "mixed_5c": (384, 192, 384, 48, 128, 128),
}
#: max pools (window, stride) that precede these blocks (i3d_net.py:205-224)
_POOL_BEFORE = {"mixed_3b": ((1, 3, 3), (1, 2, 2)),
                "mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "mixed_5b": ((2, 2, 2), (2, 2, 2))}


def _out_channels(channels) -> int:
    return channels[0] + channels[2] + channels[4] + channels[5]


class I3D(nn.Module):
    """``(N, T, 224, 224, C)`` in [-1, 1] -> ``(N, 1024)`` features
    (``features=True``) or ``(N, num_classes)`` time-mean logits. C = 3 for
    the rgb stream, 2 for flow."""

    def __init__(self, num_classes: int = 400, in_channels: int = 3) -> None:
        super().__init__()
        self.conv3d_1a_7x7 = Unit3D(in_channels, 64, (7, 7, 7), (2, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(64, 64)
        self.conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        ch = 192
        for name, channels in MIXED_CHANNELS.items():
            setattr(self, name, Mixed(ch, channels))
            ch = _out_channels(channels)
        self.conv3d_0c_1x1 = Unit3D(FEATURE_DIM, num_classes, use_bias=True,
                                    use_bn=False, relu=False)

    def forward(self, x: torch.Tensor, features: bool = True) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)  # NDHWC -> NCDHW
        x = self.conv3d_1a_7x7(x)
        x = max_pool_tf_ceil(x, (1, 3, 3), (1, 2, 2))
        x = self.conv3d_2b_1x1(x)
        x = self.conv3d_2c_3x3(x)
        for name in MIXED_CHANNELS:
            if name in _POOL_BEFORE:
                x = max_pool_tf_ceil(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        t, h, w = x.shape[2:]
        if t < 2 or h < 7 or w < 7:
            raise ValueError(
                f"I3D head needs a (2,7,7) pool window, got {(t, h, w)}; "
                "use stack_size >= 10 and 224x224 crops")
        x = window_mean(x)
        if not features:
            x = self.conv3d_0c_1x1(x)
        return x[:, :, :, 0, 0].mean(dim=2)
