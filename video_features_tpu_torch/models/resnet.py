"""ResNet-18/34/50/101/152 (torchvision v1.5) in PyTorch.

Port of ``video_features_tpu/models/resnet.py`` (reference
models/resnet/extract_resnet.py:46-56, torchvision's ``resnet*``): the
stride of a bottleneck on its 3x3 conv, a max pool whose padding never
wins (torch's implicit padding, ``-inf``), the mean over H and W, and the
ImageNet ``fc`` head kept aside for ``show_pred`` (the reference swaps it
for Identity). The convolutions are cuDNN through ``nn.Conv2d``.

Module names are torchvision's state-dict keys (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0/1``, ``fc``), so a torchvision
checkpoint loads with ``load_state_dict(strict=True)``.

Public layout is the JAX one: ``(N, H, W, 3)`` normalised input in the
working dtype -> ``(N, D)`` features in that dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BNInf

#: stage block counts and block kind per variant
VARIANTS = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
    "resnet101": ((3, 4, 23, 3), "bottleneck"),
    "resnet152": ((3, 8, 36, 3), "bottleneck"),
}

FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048,
                "resnet101": 2048, "resnet152": 2048}


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), BNInf(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = BNInf(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BNInf(planes)
        self.downsample = (_downsample(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BNInf(planes)
        self.conv2 = _conv(planes, planes, 3, stride)  # v1.5: stride here
        self.bn2 = BNInf(planes)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = BNInf(cout)
        self.downsample = (_downsample(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Backbone ``(N, H, W, 3)`` -> ``(N, D)`` pooled features; ``fc`` is
    the ImageNet head (``self.fc(features)`` gives the logits)."""

    def __init__(self, variant: str = "resnet50",
                 num_classes: int = 1000) -> None:
        super().__init__()
        stages, kind = VARIANTS[variant]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BNInf(64)
        cin = 64
        for i, blocks in enumerate(stages):
            planes = 64 * 2 ** i
            layer = [block(cin, planes, 1 if i == 0 else 2)]
            cin = planes * block.expansion
            layer += [block(cin, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(FEATURE_DIMS[variant], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # AdaptiveAvgPool2d(1) as jnp.mean computes it: float32 sum, one
        # rounding to the activation dtype
        return x.float().mean(dim=(2, 3)).to(x.dtype)
