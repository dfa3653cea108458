"""S3D (separable 3D Inception, Kinetics-400) in PyTorch.

Port of ``video_features_tpu/models/s3d.py`` (reference
models/s3d/s3d_src/s3d.py): an Inception-v1 trunk whose kxkxk convs are a
spatial (1,k,k) conv and a temporal (k,1,1) conv, each followed by
BatchNorm (eps 1e-3, not torch's 1e-5) and ReLU (``SepConv3d``); 1x1x1 convs
are conv + BN + ReLU (``BasicConv3d``); nine ``Mixed`` blocks. Max pools pad
with -inf (torch's implicit max-pool padding). Head: mean over (H, W), a
size-2 sliding mean over time (the reference's ``avg_pool3d((2, H, W),
stride 1)``), the optional 1x1x1 conv classifier, then the mean over time;
in bfloat16 each mean sums in float32 and rounds once, as ``jnp.mean`` does.

Module names are the reference's keys (``base.<idx>.``, ``fc.0``), so
``S3D_kinetics400_torchified.pt`` loads with ``load_state_dict``.

Public layout is the JAX one: ``(N, T, 224, 224, 3)`` in [0, 1] ->
``(N, 1024)`` features (``features=True``) or ``(N, 400)`` logits, in the
input's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BNInf

FEATURE_DIM = 1024
BN_EPS = 1e-3  # s3d.py:56

# (branch0 1x1, (b1 reduce, b1 out), (b2 reduce, b2 out), b3 pool proj)
MIXED_SPECS = {
    "m3b": (64, (96, 128), (16, 32), 32),
    "m3c": (128, (128, 192), (32, 96), 64),
    "m4b": (192, (96, 208), (16, 48), 64),
    "m4c": (160, (112, 224), (24, 64), 64),
    "m4d": (128, (128, 256), (24, 64), 64),
    "m4e": (112, (144, 288), (32, 64), 64),
    "m4f": (256, (160, 320), (32, 128), 128),
    "m5b": (256, (160, 320), (32, 128), 128),
    "m5c": (384, (192, 384), (48, 128), 128),
}


class BasicConv3d(nn.Module):
    def __init__(self, in_planes: int, out_planes: int) -> None:
        super().__init__()
        self.conv = nn.Conv3d(in_planes, out_planes, 1, bias=False)
        self.bn = BNInf(out_planes, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class SepConv3d(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1) -> None:
        super().__init__()
        k, s, p = kernel, stride, pad
        self.conv_s = nn.Conv3d(in_planes, out_planes, (1, k, k), (1, s, s),
                                (0, p, p), bias=False)
        self.bn_s = BNInf(out_planes, BN_EPS)
        self.conv_t = nn.Conv3d(out_planes, out_planes, (k, 1, 1), (s, 1, 1),
                                (p, 0, 0), bias=False)
        self.bn_t = BNInf(out_planes, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn_s(self.conv_s(x)))
        return torch.relu(self.bn_t(self.conv_t(x)))


class _MaxPool(nn.Module):
    """Parameter-free max pool, -inf padding (index 0 of the reference's
    ``branch3`` Sequential and the trunk's pools)."""

    def __init__(self, window: Tuple[int, int, int],
                 stride: Tuple[int, int, int],
                 pad: Tuple[int, int, int]) -> None:
        super().__init__()
        self.window, self.stride, self.pad = window, stride, pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, self.window, self.stride, self.pad)


class Mixed(nn.Module):
    def __init__(self, in_planes: int, spec) -> None:
        super().__init__()
        b0, (b1r, b1), (b2r, b2), b3 = spec
        self.branch0 = nn.Sequential(BasicConv3d(in_planes, b0))
        self.branch1 = nn.Sequential(BasicConv3d(in_planes, b1r),
                                     SepConv3d(b1r, b1))
        self.branch2 = nn.Sequential(BasicConv3d(in_planes, b2r),
                                     SepConv3d(b2r, b2))
        self.branch3 = nn.Sequential(_MaxPool((3, 3, 3), (1, 1, 1),
                                              (1, 1, 1)),
                                     BasicConv3d(in_planes, b3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x),
                          self.branch2(x), self.branch3(x)], dim=1)


def _out_planes(spec) -> int:
    return spec[0] + spec[1][1] + spec[2][1] + spec[3]


class S3D(nn.Module):
    def __init__(self, num_classes: int = 400) -> None:
        super().__init__()
        layers = [SepConv3d(3, 64, kernel=7, stride=2, pad=3),
                  _MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                  BasicConv3d(64, 64), SepConv3d(64, 192),
                  _MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1))]
        ch = 192
        for name in MIXED_SPECS:
            if name == "m4b":
                layers.append(_MaxPool((3, 3, 3), (2, 2, 2), (1, 1, 1)))
            elif name == "m5b":
                layers.append(_MaxPool((2, 2, 2), (2, 2, 2), (0, 0, 0)))
            layers.append(Mixed(ch, MIXED_SPECS[name]))
            ch = _out_planes(MIXED_SPECS[name])
        self.base = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Conv3d(FEATURE_DIM, num_classes, 1,
                                          bias=True))

    def forward(self, x: torch.Tensor, features: bool = True
                ) -> torch.Tensor:
        x = self.base(x.permute(0, 4, 1, 2, 3))  # NDHWC -> NCDHW
        if x.shape[2] < 2:
            raise ValueError(
                f"S3D needs >=2 temporal positions at the head, got "
                f"{x.shape[2]}; use stack_size >= 16")
        dtype = x.dtype
        x = x.float().mean(dim=(3, 4)).to(dtype)       # (N, C, T)
        x = (x[:, :, :-1] + x[:, :, 1:]) * 0.5          # (N, C, T-1)
        if not features:
            x = self.fc(x[:, :, :, None, None])[:, :, :, 0, 0]
        return x.float().mean(dim=2).to(dtype)
