"""PWC-Net optical flow in PyTorch (port of ``video_features_tpu/models/pwc.py``).

The sniklaus pytorch-pwc network with the sintel checkpoint (reference
models/pwc/pwc_src/pwc_net.py): a 6-level conv feature pyramid with
LeakyReLU(0.1) everywhere, a coarse-to-fine decoder per level (transposed
convolutions upsample the flow and the features, the second image's level is
warped by the upsampled flow, an 81-channel cost volume, a DenseNet-style
concat stack, a flow head), and a dilated refiner added to the finest (1/4)
flow. The input is taken from RGB to BGR and divided by 255, resized
bilinearly to multiples of 64, and the flow is resized back, multiplied by
20 and rescaled per axis.

Public functions keep the JAX layouts: images ``(B, H, W, 3)`` in [0, 255],
flow ``(B, H, W, 2)``; :func:`bilinear_warp` and the cost volume take NCHW,
as the modules run. Module names follow the reference checkpoint's keys
(``moduleExtractor.moduleOne.0.weight``, ``moduleSix.moduleUpflow.weight``,
``moduleRefiner.moduleMain.12.bias``), so ``pwc_net_sintel.pt`` loads with
``load_state_dict``.

``dtype=torch.bfloat16`` is the JAX package's bfloat16 mode: the conv stacks,
the upsampled features, the warp's gather and the cost volumes run in
bfloat16, while the flow tensors, the upflow transposed convolution, the
warp's coordinates and blend, the decoders' flow heads (``moduleSix.0``) and
the refiner's last conv (``moduleMain.12``) stay float32. The weights stay
float32 (the JAX ``ExtractPWC`` does not cast PWC's params; flax casts per
op), and each bfloat16 layer casts its weight at use (:class:`Conv2d`), so
the whole module must not go through ``cast_floating_``. The output is
float32. The caller keeps TF32 off (``device.set_precision``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.cost_volume import cost_volume_nchw

#: per-stage channel widths of the feature pyramid (pwc_net.py:57-113)
PYRAMID = (("moduleOne", 16), ("moduleTwo", 32), ("moduleThr", 64),
           ("moduleFou", 96), ("moduleFiv", 128), ("moduleSix", 196))
#: the decoders, coarse to fine, by level and name (pwc_net.py:277-287)
LEVELS = ((6, "moduleSix"), (5, "moduleFiv"), (4, "moduleFou"),
          (3, "moduleThr"), (2, "moduleTwo"))
#: the dense layers of a decoder: name and output width (pwc_net.py:144-173)
DENSE = (("moduleOne", 128), ("moduleTwo", 128), ("moduleThr", 96),
         ("moduleFou", 64), ("moduleFiv", 32))
DENSE_OUT = sum(ch for _, ch in DENSE)
#: magnification of the upsampled flow before the warp (pwc_net.py:137)
DBL_BACKWARD = {2: 5.0, 3: 2.5, 4: 1.25, 5: 0.625}
#: cost-volume channels, (2 * 4 + 1) ** 2
VOLUME = 81


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's dtype: float32 weights are
    cast at use, as flax's ``Conv(dtype=...)`` casts its params per op."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


def correlation_volume(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """81-channel windowed cost volume, NCHW (correlation.py:47-115)."""
    return cost_volume_nchw(f1, f2)


def bilinear_warp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``Backward`` (pwc_net.py:25-50) on NCHW: sample ``feat`` at
    ``grid + flow`` with torch-1.2 ``grid_sample`` semantics (align_corners
    true, zeros padding), then zero the samples whose all-ones channel came
    back at most 0.999 after the same interpolation.

    The four corners are read directly, as the JAX function does: the
    coordinates and weights are float32 in every mode, the corners are
    gathered in ``feat``'s dtype and blended in float32, in JAX's order
    (x0 then x0 + 1, y0 then y0 + 1), so the mask is JAX's bit for bit; a
    ``grid_sample`` would normalise the coordinates to [-1, 1] and back,
    which moves them by ~1e-7 and can flip a mask pixel at the threshold."""
    b, c, h, w = feat.shape
    flow32 = flow.float()
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=feat.device),
        torch.arange(w, dtype=torch.float32, device=feat.device),
        indexing="ij")
    x = gx + flow32[:, 0]
    y = gy + flow32[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = feat.reshape(b, c, h * w)
    sampled = torch.zeros((b, c, h * w), dtype=torch.float32,
                          device=feat.device)
    ones = torch.zeros((b, h, w), dtype=torch.float32, device=feat.device)
    for xi, wx in ((x0, 1.0 - (x - x0)), (x0 + 1, x - x0)):
        for yi, wy in ((y0, 1.0 - (y - y0)), (y0 + 1, y - y0)):
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            # an out-of-plane corner has weight 0, so any in-plane index
            # will do; a NaN or huge coordinate never reaches the cast
            xc = torch.where(valid, xi, 0.0).long()
            yc = torch.where(valid, yi, 0.0).long()
            idx = (yc * w + xc).reshape(b, 1, h * w).expand(b, c, h * w)
            corner = torch.gather(flat, 2, idx)
            weight = torch.where(valid, wx * wy, 0.0)
            sampled = sampled + weight.reshape(b, 1, h * w) * corner.float()
            ones = ones + weight
    # mask rule (pwc_net.py:47-49): > 0.999 -> 1, anything below -> 0
    mask = (ones > 0.999).float().reshape(b, 1, h * w)
    return (sampled * mask).reshape(b, c, h, w).to(feat.dtype)


def _upconv(c_in: int) -> nn.ConvTranspose2d:
    """torch ``ConvTranspose2d(k=4, stride=2, pad=1)``: twice the input
    size (pwc_net.py:133-134)."""
    return nn.ConvTranspose2d(c_in, 2, 4, stride=2, padding=1)


def _conv_transpose(module: nn.ConvTranspose2d, x: torch.Tensor
                    ) -> torch.Tensor:
    """``module`` in ``x``'s dtype, its weights cast at use."""
    return F.conv_transpose2d(x, module.weight.to(x.dtype),
                              module.bias.to(x.dtype), stride=2, padding=1)


def _block(c_in: int, c_out: int, stride: int = 1, dilation: int = 1
           ) -> List[nn.Module]:
    return [Conv2d(c_in, c_out, 3, stride=stride, padding=dilation,
                   dilation=dilation), nn.LeakyReLU(0.1)]


class Extractor(nn.Module):
    """pwc_net.py:53-119: 6 stages of [stride-2 conv, conv, conv]."""

    def __init__(self) -> None:
        super().__init__()
        c_in = 3
        for name, ch in PYRAMID:
            setattr(self, name, nn.Sequential(*_block(c_in, ch, stride=2),
                                              *_block(ch, ch),
                                              *_block(ch, ch)))
            c_in = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for name, _ in PYRAMID:
            x = getattr(self, name)(x)
            feats.append(x)
        return feats


def decoder_width(level: int) -> int:
    """A decoder's input channels (pwc_net.py:129-132): the 81-channel
    volume, plus the first image's features, the flow and the upsampled
    features below level 6."""
    if level == 6:
        return VOLUME
    return VOLUME + PYRAMID[level - 1][1] + 2 + 2


class Decoder(nn.Module):
    """pwc_net.py:125-211: returns ``(flow, feat)``; the flow is float32 in
    every mode (it feeds the warp's coordinates)."""

    def __init__(self, level: int) -> None:
        super().__init__()
        self.level = level
        if level < 6:
            self.moduleUpflow = _upconv(2)
            self.moduleUpfeat = _upconv(decoder_width(level + 1) + DENSE_OUT)
        c = decoder_width(level)
        for name, ch in DENSE:
            setattr(self, name, nn.Sequential(*_block(c, ch)))
            c += ch
        self.moduleSix = nn.Sequential(Conv2d(c, 2, 3, padding=1))

    def forward(self, first: torch.Tensor, second: torch.Tensor,
                prev: Optional[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if prev is None:
            feat = leaky(correlation_volume(first, second))
        else:
            prev_flow, prev_feat = prev
            flow = _conv_transpose(self.moduleUpflow, prev_flow.float())
            upfeat = _conv_transpose(self.moduleUpfeat,
                                     prev_feat.to(first.dtype))
            warped = bilinear_warp(second, flow * DBL_BACKWARD[self.level])
            volume = leaky(correlation_volume(first, warped))
            feat = torch.cat([volume, first, flow.to(first.dtype), upfeat],
                             dim=1)
        for name, _ in DENSE:
            # new features first (pwc_net.py:196-200)
            feat = torch.cat([getattr(self, name)(feat), feat], dim=1)
        # the flow head runs in float32: its output is coordinates
        return self.moduleSix(feat.float()), feat


class Refiner(nn.Module):
    """pwc_net.py:213-235: the dilated context network; its last conv
    (``moduleMain.12``, the flow residual) runs in float32."""

    SPECS = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))

    def __init__(self) -> None:
        super().__init__()
        layers: List[nn.Module] = []
        c = decoder_width(2) + DENSE_OUT
        for ch, dil in self.SPECS:
            layers += _block(c, ch, dilation=dil)
            c = ch
        layers.append(Conv2d(c, 2, 3, padding=1))
        self.moduleMain = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.moduleMain[:-1](x)
        return self.moduleMain[-1](x.float())


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` on NCHW:
    half-pixel centres, no antialias. On PWC's paths every resize is an
    upsampling, where it agrees with ``jax.image.resize`` at the edges."""
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)


class PWCNet(nn.Module):
    """``(B, H, W, 3)`` RGB [0, 255] pairs -> ``(B, H, W, 2)`` float32 flow
    in pixels (pwc_net.py:238-296); any H, W (resized to multiples of 64
    inside)."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype={dtype}: expected torch.float32 or "
                             "torch.bfloat16")
        self.dtype = dtype
        self.moduleExtractor = Extractor()
        for level, name in LEVELS:
            setattr(self, name, Decoder(level))
        self.moduleRefiner = Refiner()

    def forward(self, image1: torch.Tensor, image2: torch.Tensor
                ) -> torch.Tensor:
        b, h, w, _ = image1.shape
        # RGB -> BGR, /255 (pwc_net.py:255-257), in float32
        x = torch.cat([image1, image2]).float().flip(-1) / 255.0
        x = x.permute(0, 3, 1, 2)
        hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
        if (hp, wp) != (h, w):
            x = resize_bilinear(x, hp, wp)
        # one shared-weight call on the concatenated pair
        pyramid = [f.chunk(2) for f in self.moduleExtractor(x.to(self.dtype))]

        prev = None
        for level, name in LEVELS:
            first, second = pyramid[level - 1]
            prev = getattr(self, name)(first, second, prev)
        flow = prev[0] + self.moduleRefiner(prev[1])
        flow = 20.0 * resize_bilinear(flow, h, w)
        scale = torch.tensor([w / wp, h / hp], dtype=torch.float32,
                             device=flow.device)
        return (flow * scale.view(1, 2, 1, 1)).permute(0, 2, 3, 1)
