"""PWC-Net's 81-channel cost volume in plain PyTorch (port of
``video_features_tpu/kernels/cost_volume.py``).

Output channel ``(dy + 4) * 9 + (dx + 4)``, dy slowest, is the channel mean
of ``f1 * shift(f2, dy, dx)`` with 4 px of zero padding (reference
models/pwc/pwc_src/correlation.py:47-115, the CuPy kernel the reference
compiles at run time).

There is no hand-written kernel here, and the JAX package has none either:
its Pallas twin of this function measured tied with XLA's fusion of the
same shifted-window products on every PWC pyramid shape in both dtypes, so
it was deleted and the XLA formulation is the reference. The op moves
bytes, not operations.

Formulation: a loop over the 9 ``dy`` rows, each batching its 9 ``dx``
shifts as one strided view of the padded ``f2`` (``unfold`` along W), so a
level costs 9 products and 9 channel sums instead of 81 of each. Both
inputs are taken to float32 first, so the products and the channel sum are
float32, then the mean is cast back to the input dtype. In bfloat16 that is
what the jitted JAX function computes: XLA fuses the bfloat16 product into
the float32 reduction and never rounds it to bfloat16 (a product of two
bfloat16 values is exact in float32). Only the order of the float32 sum
differs, which moves the final rounding by one bfloat16 ulp in a few
outputs. (Unjitted, op by op, JAX rounds each product to bfloat16 first.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CORR_RADIUS = 4


def cost_volume_nchw(f1: torch.Tensor, f2: torch.Tensor,
                     radius: int = CORR_RADIUS) -> torch.Tensor:
    """``(B, C, H, W)`` x2 -> ``(B, (2r+1)^2, H, W)`` in ``f1``'s dtype."""
    b, c, h, w = f1.shape
    n = 2 * radius + 1
    a = f1.float()[:, :, :, None, :]
    f2p = F.pad(f2.float(), (radius, radius, radius, radius))
    rows = []
    for dy in range(n):
        # (B, C, H, n, W): the n dx-shifted windows of this dy row, a view
        windows = f2p[:, :, dy:dy + h, :].unfold(3, w, 1)
        rows.append((a * windows).sum(dim=1))  # (B, H, n, W)
    vol = torch.stack(rows, dim=1)  # (B, dy, H, dx, W)
    vol = vol.permute(0, 1, 3, 2, 4).reshape(b, n * n, h, w)
    return (vol / c).to(f1.dtype)


def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                radius: int = CORR_RADIUS) -> torch.Tensor:
    """The JAX layout: ``(B, H, W, C)`` x2 -> ``(B, H, W, (2r+1)^2)``."""
    out = cost_volume_nchw(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2),
                           radius)
    return out.permute(0, 2, 3, 1)
