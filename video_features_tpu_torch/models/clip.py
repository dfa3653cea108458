"""OpenAI CLIP (both image towers and the text tower) in PyTorch.

Port of ``video_features_tpu/models/clip.py`` (reference
models/clip/clip_src/model.py): the image encoder (``VisionTransformer``
:206-240 or ``ModifiedResNet`` :96-154 with its attention-pooled head
``AttentionPool2d`` :58-93, whose query is the mean token), the text
transformer with its causal mask (:195-203, :328-334), ``QuickGELU``
``x * sigmoid(1.702 x)`` (:166-168) and LayerNorms computed in float32
(:157-163).

Attention is computed as the JAX package computes it: the scores as a
matmul in the activation dtype, the mask added, the softmax in float32 and
cast back, then the product with V; plain torch ops, so the bfloat16 result
follows JAX's.

Module names are the reference checkpoint's keys (``visual.transformer.
resblocks.0.attn.in_proj_weight``, ``mlp.c_fc``, ``visual.attnpool.q_proj``,
``visual.layer1.0.downsample.0``, ``token_embedding.weight``), so an OpenAI
state dict loads with ``load_state_dict(strict=True)`` once its metadata
keys are dropped (:func:`checkpoint_state`).

Public layout is the JAX one: ``encode_image`` takes ``(N, R, R, 3)``
normalised images in the working dtype, ``encode_text`` ``(N, context)``
token ids.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import BNInf, Dense


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int

    @property
    def is_vit(self) -> bool:
        return not isinstance(self.vision_layers, (tuple, list))


def _cfg(embed_dim, image_resolution, vision_layers, vision_width,
         vision_patch_size, transformer_width, transformer_layers=12):
    return CLIPConfig(
        embed_dim=embed_dim, image_resolution=image_resolution,
        vision_layers=vision_layers, vision_width=vision_width,
        vision_patch_size=vision_patch_size, context_length=77,
        vocab_size=49408, transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=transformer_layers)


#: the model zoo of the reference (clip.py:32-42), shaped as build_model
#: infers it from those checkpoints
CONFIGS: Dict[str, CLIPConfig] = {
    "RN50": _cfg(1024, 224, (3, 4, 6, 3), 64, None, 512),
    "RN101": _cfg(512, 224, (3, 4, 23, 3), 64, None, 512),
    "RN50x4": _cfg(640, 288, (4, 6, 10, 6), 80, None, 640),
    "RN50x16": _cfg(768, 384, (6, 8, 18, 8), 96, None, 768),
    "RN50x64": _cfg(1024, 448, (3, 15, 36, 10), 128, None, 1024),
    "ViT-B/32": _cfg(512, 224, 12, 768, 32, 512),
    "ViT-B/16": _cfg(512, 224, 12, 768, 16, 512),
    "ViT-L/14": _cfg(768, 224, 24, 1024, 14, 768),
    "ViT-L/14@336px": _cfg(768, 336, 24, 1024, 14, 768),
}

#: non-tensor entries of OpenAI's archives that build_model deletes
#: (model.py:430)
_METADATA_KEYS = ("input_resolution", "context_length", "vocab_size")


def available_models() -> List[str]:
    return list(CONFIGS)


class LNf32(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the activation dtype, the
    result cast back (model.py:157-163).

    ``x32``, where given, is the float32 value of ``x`` before its rounding
    to the activation dtype: jitted XLA fuses a residual sum into the
    LayerNorm that reads it and keeps the sum in float32 there, so in
    bfloat16 the norm reads the unrounded sum (in float32 ``x32`` is
    ``x``)."""

    def forward(self, x: torch.Tensor,
                x32: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.layer_norm(x.float() if x32 is None else x32,
                         self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def residual(x: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x + h`` in the activation dtype, and the float32 sum it rounds
    (what a following :class:`LNf32` reads)."""
    s = x.float() + h.float()
    return s.to(x.dtype), s


class QuickGELU(nn.Module):
    """``x * sigmoid(1.702 x)`` with the rounding of jitted JAX on the CPU:
    the constant in the activation dtype (a weak-typed scalar), and the
    sigmoid as ``1 / (1 + exp(-z))`` rounded after each step, as XLA
    expands ``logistic`` (bfloat16 results follow JAX's; float32 ones are
    the plain formula's to an ulp)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x * torch.tensor(1.702, dtype=x.dtype)
        return x * torch.reciprocal(1 + torch.exp(-z))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Multi-head attention of projected ``q`` (B, Tq, E), ``k`` and ``v``
    (B, Tk, E): q scaled by ``head_dim ** -0.5``, the scores in the
    activation dtype, ``mask`` added, the softmax in float32 and cast back,
    the product with V; (B, Tq, E)."""
    b, tq, e = q.shape
    hd = e // heads
    qh = (q * hd ** -0.5).reshape(b, tq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, -1, heads, hd).transpose(1, 2)
    vh = v.reshape(b, -1, heads, hd).transpose(1, 2)
    att = qh @ kh.transpose(-1, -2)
    if mask is not None:
        att = att + mask
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return (att @ vh).transpose(1, 2).reshape(b, tq, e)


class MHA(nn.Module):
    """Self-attention in ``nn.MultiheadAttention``'s key layout: the packed
    ``in_proj_weight`` (3E, E) and ``in_proj_bias``, then ``out_proj``."""

    def __init__(self, width: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Dense(width, width)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = (F.linear(x, self.in_proj_weight)
                   + self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.heads, mask))


class ResidualAttentionBlock(nn.Module):
    """model.py:171-193."""

    def __init__(self, width: int, heads: int) -> None:
        super().__init__()
        self.ln_1 = LNf32(width)
        self.attn = MHA(width, heads)
        self.ln_2 = LNf32(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Dense(width, width * 4)), ("gelu", QuickGELU()),
            ("c_proj", Dense(width * 4, width))]))

    def forward(self, x: torch.Tensor, x32: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, its float32 sum) -> the same after the block."""
        x, x32 = residual(x, self.attn(self.ln_1(x, x32), mask))
        return residual(x, self.mlp(self.ln_2(x, x32)))


class Transformer(nn.Module):
    """model.py:195-203: (B, T, width) -> the same, and its float32 value
    before the last rounding (:class:`LNf32`)."""

    def __init__(self, width: int, layers: int, heads: int) -> None:
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x32 = x.float()
        for block in self.resblocks:
            x, x32 = block(x, x32, mask)
        return x, x32


class VisionTransformer(nn.Module):
    """model.py:206-240: (B, R, R, 3) -> (B, output_dim)."""

    def __init__(self, resolution: int, patch: int, width: int, layers: int,
                 output_dim: int) -> None:
        super().__init__()
        grid = resolution // patch
        self.conv1 = nn.Conv2d(3, width, patch, patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, width))
        self.ln_pre = LNf32(width)
        self.transformer = Transformer(width, layers, width // 64)
        self.ln_post = LNf32(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x, x32 = residual(torch.cat([cls, x], dim=1),
                          self.positional_embedding.to(x.dtype))
        x, x32 = self.transformer(self.ln_pre(x, x32))
        return self.ln_post(x[:, 0], x32[:, 0]) @ self.proj.to(x.dtype)


class Bottleneck(nn.Module):
    """The anti-aliased CLIP bottleneck (model.py:10-55): every conv stride
    1, an average pool of ``stride`` after conv2 and in front of the
    downsample conv."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        cout = planes * self.expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BNInf(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BNInf(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BNInf(cout)
        self.downsample = None
        if stride > 1 or cin != cout:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(cin, cout, 1, bias=False)),
                ("1", BNInf(cout))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class AttentionPool2d(nn.Module):
    """model.py:58-93: tokens ``[mean, HW...]`` plus the positional
    embedding, one query (the mean token) over all of them, separate
    ``q_proj``/``k_proj``/``v_proj`` and the output projection ``c_proj``."""

    def __init__(self, grid: int, width: int, heads: int,
                 output_dim: int) -> None:
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, width))
        self.q_proj = Dense(width, width)
        self.k_proj = Dense(width, width)
        self.v_proj = Dense(width, width)
        self.c_proj = Dense(width, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.flatten(2).transpose(1, 2)  # NCHW -> (B, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        out = attention(self.q_proj(tokens[:, :1]), self.k_proj(tokens),
                        self.v_proj(tokens), self.heads)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    """model.py:96-154: a 3-conv stem and an average pool, anti-aliased
    bottlenecks, the attention-pool head; (B, R, R, 3) -> (B, output_dim)."""

    def __init__(self, layers: Tuple[int, int, int, int], output_dim: int,
                 heads: int, resolution: int, width: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, 2, 1, bias=False)
        self.bn1 = BNInf(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1,
                               bias=False)
        self.bn2 = BNInf(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BNInf(width)
        cin = width
        for i, blocks in enumerate(layers):
            planes = width * 2 ** i
            layer = [Bottleneck(cin, planes, 1 if i == 0 else 2)]
            cin = planes * Bottleneck.expansion
            layer += [Bottleneck(cin, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(resolution // 32, width * 32, heads,
                                        output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = torch.relu(bn(conv(x)))
        x = F.avg_pool2d(x, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


class CLIP(nn.Module):
    """The image and text encoders (model.py:243-371). Images come resized,
    cropped and normalised; text is (B, context_length) token ids
    (``utils/tokenizer.py``)."""

    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
        if cfg.is_vit:
            self.visual = VisionTransformer(
                cfg.image_resolution, cfg.vision_patch_size,
                cfg.vision_width, cfg.vision_layers, cfg.embed_dim)
        else:
            self.visual = ModifiedResNet(
                tuple(cfg.vision_layers), cfg.embed_dim,
                cfg.vision_width * 32 // 64, cfg.image_resolution,
                cfg.vision_width)
        self.transformer = Transformer(cfg.transformer_width,
                                       cfg.transformer_layers,
                                       cfg.transformer_heads)
        self.token_embedding = nn.Embedding(cfg.vocab_size,
                                            cfg.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.transformer_width))
        self.ln_final = LNf32(cfg.transformer_width)
        self.text_projection = nn.Parameter(
            torch.zeros(cfg.transformer_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(0.0))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(text) + self.positional_embedding
        n = self.cfg.context_length
        # additive causal mask: -inf strictly above the diagonal; the
        # float32 softmax keeps the -inf entries exact
        mask = torch.triu(torch.full((n, n), float("-inf"),
                                     device=x.device), diagonal=1)
        x = self.ln_final(*self.transformer(x, mask))
        # the features of the EOT token, the highest id of each row
        eot = text.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot] \
            @ self.text_projection


def checkpoint_state(sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP state dict without the metadata entries that
    ``build_model`` deletes, ready for ``load_state_dict(strict=True)``."""
    return {k: v for k, v in sd.items() if k not in _METADATA_KEYS}


def config_from_state_dict(sd: Mapping[str, torch.Tensor]) -> CLIPConfig:
    """The architecture from the checkpoint's shapes (build_model,
    model.py:399-436)."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd
                             if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd
                 if k.startswith(f"visual.layer{b}")}) for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = None
        image_resolution = out_width * 32
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}))
