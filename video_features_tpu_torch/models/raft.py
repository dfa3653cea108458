"""RAFT optical flow in PyTorch (port of ``video_features_tpu/models/raft.py``).

The princeton-vl network at test time (reference models/raft/raft_src): an
instance-norm feature encoder and a batch-norm context encoder at 1/8
resolution, an all-pairs correlation pyramid (4 levels, average-pooled),
and ``iters`` GRU refinement steps, each starting with a windowed lookup of
the pyramid (radius 4, 324 channels). The convex 8x upsample runs once, on
the final flow.

Public functions keep the JAX layouts: images ``(B, H, W, 3)`` in
[0, 255], flow ``(B, H, W, 2)``, pyramid levels ``(B, H*W, Hl, Wl)``,
lookup coords ``(B, H, W, 2)`` as (x, y). Modules run NCHW inside.

Module and parameter names follow the reference's torch key layout
(``fnet.layer1.0.conv1.weight``, ``cnet.norm1.running_mean``,
``update_block.encoder.convc1.weight``, ``update_block.mask.0.weight``, ...),
so a reference checkpoint loads with ``load_state_dict``.

The lookup (``corr_lookup_impl``): ``None`` or ``'pallas'`` runs the CUDA
kernels of ``kernels/corr_lookup.py`` on a CUDA tensor, the fused lookup +
``convc1`` kernel when ``fuse_convc1`` is ``None`` or true, the per-level
kernel and a separate ``convc1`` when it is false; ``'packed'`` packs the
pyramid once per forward (``pack_pyramid``) and runs the packed kernel, one
launch per iteration, and a separate ``convc1`` (``fuse_convc1`` is ignored,
as in the JAX ``UpdateIter``); ``'gather'`` and ``'onehot'`` are the plain
torch paths. There is no size gate: the JAX fallbacks to ``onehot``
(``pallas_lookup_supported``, and ``fused_lookup_supported``'s ``G <= 16``
and 2 MiB per query for ``packed``) exist for the TPU's VMEM envelope, and
the CUDA kernels read device memory directly, so on the card every impl
launches its kernel at every size.

``dtype=torch.bfloat16`` (with the weights cast by ``cast_floating_``) is
the JAX package's bfloat16 mode (its RAFT docstring): the conv stacks run in
bfloat16 while the images are normalised in float32 and then cast, the
instance-norm and batch-norm statistics are float32, the correlation pyramid
is float32 (from bfloat16 fmaps, float32 accumulation), the lookup and the
coords stay float32, the flow and the lookup output join the hidden state's
dtype before the motion encoder, ``delta`` is promoted back to float32 on
the add to the coords, and the upsample softmax runs in float32. The fused
kernel takes ``convc1``'s weight upcast to float32 once per forward,
projects in float32, and its output is cast to bfloat16. The caller keeps
TF32 off (``device.set_precision``) so the float32 parts are full float32.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import corr_lookup as cl
from .common import BNInf

CORR_LEVELS = 4
CORR_RADIUS = 4
HIDDEN_DIM = 128
CONTEXT_DIM = 128
ITERS = 20
LOOKUP_IMPLS = (None, "pallas", "packed", "gather", "onehot")


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d(affine=False)`` at eval: per-sample, per-channel
    normalisation over H, W with the biased variance, in float32."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    """Parameter-free module form of :func:`instance_norm` (holds the place
    of the reference's ``nn.InstanceNorm2d`` in ``Sequential`` indices)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "batch":
        return BNInf(planes)
    if norm_fn == "instance":
        return InstanceNorm()
    return nn.Identity()


class ResidualBlock(nn.Module):
    """extractor.py ResidualBlock. With stride 2 the reference registers its
    ``norm3`` twice (as ``norm3`` and ``downsample.1``); so does this one,
    so the state-dict keys match."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """extractor.py BasicEncoder (fnet: instance norm; cnet: batch norm)."""

    def __init__(self, output_dim: int, norm_fn: str) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        layers = []
        in_planes = 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(in_planes, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    """update.py BasicMotionEncoder. ``convc1`` is a 1x1 conv over the 324
    lookup channels; on the fused path its weight feeds the CUDA lookup +
    projection kernel instead (rows in the lookup's channel order)."""

    def __init__(self) -> None:
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def convc1_matrix(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``convc1`` as the kernel's ``(324, 256)`` float32 weight and bias
        (upcast from bfloat16 weights, as the JAX kernel upcasts in-kernel)."""
        w = self.convc1.weight.float()
        return w.reshape(w.shape[0], w.shape[1]).t().contiguous(), \
            self.convc1.bias.float().contiguous()

    def forward(self, flow: torch.Tensor, cor: torch.Tensor) -> torch.Tensor:
        """flow (B, 2, H, W); cor (B, 256, H, W) already through convc1 +
        relu."""
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """Two-pass separable GRU (update.py:39-65)."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM,
                 input_dim: int = 128 + CONTEXT_DIM) -> None:
        super().__init__()
        ch = hidden_dim + input_dim
        for suffix, kernel, pad in (("1", (1, 5), (0, 2)),
                                    ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(ch, hidden_dim, kernel, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = HIDDEN_DIM,
                 hidden_dim: int = 256) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class MaskHead(nn.Sequential):
    """update.py:130-133 (``update_block.mask``) with the 0.25 scale of
    update.py:143; indices 0 and 2 match the reference's keys."""

    def __init__(self) -> None:
        super().__init__(nn.Conv2d(HIDDEN_DIM, 256, 3, padding=1),
                         nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 0.25 * super().forward(x)


class UpdateIter(nn.Module):
    """One RAFT iteration: the correlation lookup + BasicUpdateBlock
    (update.py:123-144). Registered as ``update_block``, with ``mask`` (the
    reference's ``update_block.mask``) applied once after the loop."""

    def __init__(self) -> None:
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = MaskHead()

    def forward(self, net: torch.Tensor, inp: torch.Tensor,
                coords0: torch.Tensor, coords1: torch.Tensor,
                lookup: Callable[[torch.Tensor], torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """net/inp (B, C, H, W); coords (B, H, W, 2) float32; ``lookup``
        maps coords1 to the motion encoder's ``relu(convc1(lookup))``
        ``(B, 256, H, W)`` in the hidden state's dtype. Returns the new
        hidden state and coords1 (float32)."""
        flow = (coords1 - coords0).permute(0, 3, 1, 2).to(net.dtype)
        motion = self.encoder(flow, lookup(coords1))
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        return net, (coords1 + delta.permute(0, 2, 3, 1).to(coords1.dtype)
                     ).contiguous()


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = CORR_LEVELS) -> List[torch.Tensor]:
    """All-pairs correlation + average-pool pyramid (corr.py:13-27).

    fmaps ``(B, C, H, W)``. Returns per level ``(B, H*W, Hl, Wl)`` float32.
    Pooling is ``avg_pool2d(2, stride=2)`` in floor mode: an odd trailing
    row or column is dropped, and a level too small to pool is 0x0."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).float()
    f2 = fmap2.reshape(b, c, h * w).float()
    corr = torch.matmul(f1.transpose(1, 2), f2) / math.sqrt(c)
    corr = corr.reshape(b, h * w, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        hl, wl = corr.shape[2] // 2, corr.shape[3] // 2
        corr = corr[:, :, :2 * hl, :2 * wl].reshape(
            b, h * w, hl, 2, wl, 2).sum(dim=(3, 5)) / 4.0
        pyramid.append(corr)
    return pyramid


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned 8x convex-combination upsample (raft.py:104-115), NHWC.

    flow ``(B, H, W, 2)``; mask ``(B, H, W, 576)``. Returns
    ``(B, 8H, 8W, 2)``; the softmax runs in float32."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.float().reshape(b, h, w, 9, 8, 8), dim=3)
    fpad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    taps = [fpad[:, dy:dy + h, dx:dx + w, :]
            for dy in range(3) for dx in range(3)]
    nb = torch.stack(taps, dim=3)  # (B, H, W, 9, 2)
    up = torch.einsum("bhwkij,bhwkc->bhwijc", mask, nb)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


def pad_to_multiple(x, mult: int = 8, mode: str = "sintel"
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """InputPadder pad amounts (raft.py:30-40) for an ``(..., H, W, C)``
    shape: ``((top, bottom), (left, right))``."""
    ht, wd = x.shape[-3], x.shape[-2]
    pad_ht = (((ht // mult) + 1) * mult - ht) % mult
    pad_wd = (((wd // mult) + 1) * mult - wd) % mult
    if mode == "sintel":
        return ((pad_ht // 2, pad_ht - pad_ht // 2),
                (pad_wd // 2, pad_wd - pad_wd // 2))
    return ((0, pad_ht), (pad_wd // 2, pad_wd - pad_wd // 2))


def padded_flow(model: "RAFT", pairs: torch.Tensor, mode: str = "sintel"):
    """RAFT on a ``(B, 2, H, W, 3)`` float pair batch with InputPadder
    semantics (edge padding to /8). Returns the flow at the *padded*
    resolution and the ``((top, bottom), (left, right))`` amounts."""
    (pt, pb), (pl, pr) = pad_to_multiple(pairs[:, 0], mode=mode)

    def pad(img):  # NHWC -> edge-padded NHWC
        img = img.permute(0, 3, 1, 2)
        img = F.pad(img, (pl, pr, pt, pb), mode="replicate")
        return img.permute(0, 2, 3, 1)

    return model(pad(pairs[:, 0]), pad(pairs[:, 1])), ((pt, pb), (pl, pr))


class RAFT(nn.Module):
    """``(B, H, W, 3)`` [0, 255] image pairs -> ``(B, H, W, 2)`` flow in
    pixels; H and W divisible by 8 (see :func:`padded_flow`)."""

    def __init__(self, iters: int = ITERS, corr_lookup_impl: Optional[str] = None,
                 fuse_convc1: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if corr_lookup_impl not in LOOKUP_IMPLS:
            raise ValueError(f"corr_lookup_impl={corr_lookup_impl!r}: "
                             f"expected one of {LOOKUP_IMPLS}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype={dtype}: expected torch.float32 or "
                             "torch.bfloat16")
        self.iters = iters
        self.corr_lookup_impl = corr_lookup_impl
        self.fuse_convc1 = True if fuse_convc1 is None else bool(fuse_convc1)
        self.dtype = dtype
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HIDDEN_DIM + CONTEXT_DIM, "batch")
        self.update_block = UpdateIter()

    def _lookup(self, pyramid: List[torch.Tensor], dtype: torch.dtype
                ) -> Callable[[torch.Tensor], torch.Tensor]:
        """coords1 -> ``relu(convc1(lookup))`` ``(B, 256, H, W)`` in
        ``dtype`` through the configured impl. What does not change over
        the GRU loop (the packed plane, convc1 in float32 for the fused
        kernel) is made here, once per forward."""
        impl = self.corr_lookup_impl
        convc1 = self.update_block.encoder.convc1
        if impl in (None, "pallas") and self.fuse_convc1:
            proj = self.update_block.encoder.convc1_matrix()

            def fused(coords1):
                # a channels-last view, as convc1's output is on the other
                # paths
                cor = cl.corr_lookup_proj_cuda(pyramid, coords1, *proj)
                return cor.permute(0, 3, 1, 2).to(dtype)
            return fused
        if impl == "packed":
            packed, metas = cl.pack_pyramid(pyramid)

            def taps(coords1):
                return cl.corr_lookup_packed_cuda(packed, metas, coords1)
        elif impl in (None, "pallas"):
            def taps(coords1):
                return cl.corr_lookup_level_cuda(pyramid, coords1)
        elif impl == "onehot":
            def taps(coords1):
                return cl.corr_lookup_onehot_ref(pyramid, coords1)
        else:
            def taps(coords1):
                return cl.corr_lookup_gather_ref(pyramid, coords1)

        def unfused(coords1):
            corr = taps(coords1).to(dtype).permute(0, 3, 1, 2)
            return F.relu(convc1(corr))
        return unfused

    def forward(self, image1: torch.Tensor, image2: torch.Tensor
                ) -> torch.Tensor:
        # normalised in float32, then cast to the working dtype
        image1 = (2 * (image1.float() / 255.0) - 1.0).to(self.dtype)
        image2 = (2 * (image2.float() / 255.0) - 1.0).to(self.dtype)
        image1 = image1.permute(0, 3, 1, 2)
        image2 = image2.permute(0, 3, 1, 2)
        # one shared-weight call on the concatenated pair (raft.py:132)
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        pyramid = build_corr_pyramid(fmap1, fmap2)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :HIDDEN_DIM])
        inp = F.relu(cnet[:, HIDDEN_DIM:])

        b, _, h8, w8 = net.shape
        gy, gx = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=net.device),
            torch.arange(w8, dtype=torch.float32, device=net.device),
            indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1).expand(b, h8, w8, 2)
        coords1 = coords0.contiguous()
        lookup = self._lookup(pyramid, net.dtype)
        for _ in range(self.iters):
            net, coords1 = self.update_block(net, inp, coords0, coords1,
                                             lookup)
        mask = self.update_block.mask(net).permute(0, 2, 3, 1)
        return convex_upsample(coords1 - coords0, mask)
