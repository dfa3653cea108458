"""R(2+1)D video networks (18/34 layers) in PyTorch.

Port of ``video_features_tpu/models/r21d.py``: torchvision's ``VideoResNet``
with the R(2+1)D stem and factorised convolutions (each 3D conv is a
spatial (1,3,3) conv into ``midplanes`` channels, BN, ReLU, then a temporal
(3,1,1) conv), the pooled 512-d features, and the Kinetics-400 ``fc`` head
kept aside for ``show_pred`` (reference extract_r21d.py:116-118). The dense
convolutions are cuDNN through ``nn.Conv3d``.

Module names are torchvision's and IG-65M's state-dict keys (``stem.0``,
``layer1.0.conv1.0.0``, ``layer2.0.downsample.1``, ``fc``), so a real
checkpoint loads with ``load_state_dict(strict=True)``.

Public layout is the JAX one: ``(N, T, H, W, 3)`` normalised input in the
working dtype -> ``(N, 512)`` features in that dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from .common import BNInf

VARIANTS = {
    # model_name (reference extract_r21d.py:27-40) -> (stage blocks,
    # default stack/step)
    "r2plus1d_18_16_kinetics": ((2, 2, 2, 2), 16),
    "r2plus1d_34_32_ig65m_ft_kinetics": ((3, 4, 6, 3), 32),
    "r2plus1d_34_8_ig65m_ft_kinetics": ((3, 4, 6, 3), 8),
}

FEATURE_DIM = 512
#: K400 normalisation of the reference transform (extract_r21d.py:50-55)
R21D_MEAN = (0.43216, 0.394666, 0.37645)
R21D_STD = (0.22803, 0.22145, 0.216989)


def midplanes(in_planes: int, out_planes: int) -> int:
    """Channels between the spatial and the temporal conv, keeping the
    parameter count of the full 3x3x3 conv."""
    return (in_planes * out_planes * 3 * 3 * 3) // (
        in_planes * 3 * 3 + 3 * out_planes)


class Conv2Plus1D(nn.Sequential):
    """Spatial (1,3,3) conv -> BN -> ReLU -> temporal (3,1,1) conv
    (indices 0, 1, 2, 3 of torchvision's ``Conv2Plus1D``)."""

    def __init__(self, in_planes: int, out_planes: int, mid_planes: int,
                 stride: int = 1) -> None:
        super().__init__(
            nn.Conv3d(in_planes, mid_planes, (1, 3, 3), (1, stride, stride),
                      (0, 1, 1), bias=False),
            BNInf(mid_planes),
            nn.ReLU(),
            nn.Conv3d(mid_planes, out_planes, (3, 1, 1), (stride, 1, 1),
                      (1, 0, 0), bias=False))


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2Plus1D(in_planes, planes, midplanes(in_planes, planes),
                        stride),
            BNInf(planes), nn.ReLU())
        self.conv2 = nn.Sequential(
            Conv2Plus1D(planes, planes, midplanes(planes, planes)),
            BNInf(planes))
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_planes, planes, 1, (stride, stride, stride),
                          bias=False),
                BNInf(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv2(self.conv1(x)) + identity)


class R2Plus1D(nn.Module):
    """Backbone ``(N, T, H, W, 3)`` -> ``(N, 512)`` pooled features; ``fc``
    is the Kinetics-400 head (``self.fc(features)`` gives the logits)."""

    def __init__(self, variant: str = "r2plus1d_18_16_kinetics",
                 num_classes: int = 400) -> None:
        super().__init__()
        stages, _ = VARIANTS[variant]
        self.stem = nn.Sequential(
            nn.Conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=False),
            BNInf(45), nn.ReLU(),
            nn.Conv3d(45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0), bias=False),
            BNInf(64), nn.ReLU())
        in_planes = 64
        for i, blocks in enumerate(stages):
            planes = 64 * 2 ** i
            layer = [BasicBlock(in_planes, planes, 1 if i == 0 else 2)]
            layer += [BasicBlock(planes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            in_planes = planes
        self.fc = nn.Linear(FEATURE_DIM, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 4, 1, 2, 3))  # NDHWC -> NCDHW
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # AdaptiveAvgPool3d(1) as jnp.mean computes it: float32 sum, one
        # rounding to the activation dtype
        return x.float().mean(dim=(2, 3, 4)).to(x.dtype)
