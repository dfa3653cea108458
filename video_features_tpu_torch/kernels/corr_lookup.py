"""RAFT correlation-pyramid lookup: CUDA kernels and their plain versions.

Port of ``video_features_tpu/kernels/corr_lookup.py``. Two kernels, written
by hand for Hopper in ``csrc/corr_lookup.cu`` (design notes and what bounds
each on the card are in that file):

  - :func:`corr_lookup_level_cuda` replaces ``_level_kernel`` (launched by
    ``corr_lookup_level_pallas``, API ``corr_lookup_pallas``): the 81-tap
    bilinear window per level, one launch per level, written straight into
    its 81-channel slice of the ``(B, H, W, 324)`` output;
  - :func:`corr_lookup_proj_cuda` replaces ``_proj_kernel`` (launched by
    ``_corr_lookup_proj_flat``, API ``corr_lookup_proj``): all four levels
    and RAFT's motion-encoder ``convc1``, ``relu(lookup @ W + b)``, one
    launch per GRU iteration.

Both take the unpadded pyramid levels ``(B, P, Hl, Wl)`` as
:func:`video_features_tpu_torch.models.raft.build_corr_pyramid` returns them
(the pair batch folds into ``Q = B * P`` queries) and coords ``(B, H, W, 2)``
as level-0 (x, y). The TPU kernels' 8x128 tile padding and one-hot /
hat-function selector matmuls were workarounds for Mosaic's missing gather;
the CUDA kernels read the four bilinear corners directly.

Beside each kernel is its plain PyTorch version, :func:`corr_lookup_gather_ref`
(``torch.gather``) and :func:`corr_lookup_proj_ref` (the same plus one
``torch.matmul``). A wrapper takes the plain version only for a CPU tensor;
for a CUDA tensor it launches its kernel or raises. Each wrapper counts its
kernel launches in a plain integer attribute, ``launches``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import build

RADIUS = 4
LEVELS = 4
TAPS = (2 * RADIUS + 1) ** 2


# ---- plain versions ------------------------------------------------------

def corr_lookup_gather_ref(pyramid: Sequence[torch.Tensor],
                           coords: torch.Tensor,
                           radius: int = RADIUS) -> torch.Tensor:
    """Windowed bilinear lookup (reference corr.py:29-50) with
    ``torch.gather``: pyramid per level ``(B, P, Hl, Wl)``, coords
    ``(B, H, W, 2)`` level-0 (x, y). Returns ``(B, H, W, L * (2r+1)^2)``,
    per level the x-offset varying slowest, zeros outside the plane."""
    b, h, w, _ = coords.shape
    p = h * w
    n = 2 * radius + 1
    d = torch.linspace(-radius, radius, n, dtype=torch.float32,
                       device=coords.device)
    off_slow = d.repeat_interleave(n)  # added to x (the reference's dy quirk)
    off_fast = d.repeat(n)             # added to y
    cx = coords[..., 0].reshape(b, p, 1)
    cy = coords[..., 1].reshape(b, p, 1)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2], corr.shape[3]
        acc = torch.zeros((b, p, n * n), dtype=corr.dtype,
                          device=coords.device)
        if hl * wl == 0:  # a level pooled to nothing: all taps are zeros
            out.append(acc)
            continue
        flat = corr.reshape(b, p, hl * wl)
        x = cx / (2 ** lvl) + off_slow
        y = cy / (2 ** lvl) + off_fast
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        for xi, wxf in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
            for yi, wyf in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
                valid = (xi >= 0) & (xi <= wl - 1) & (yi >= 0) & (yi <= hl - 1)
                idx = (yi.clamp(0, hl - 1) * wl
                       + xi.clamp(0, wl - 1)).to(torch.int64)
                val = torch.gather(flat, 2, idx)
                acc = acc + torch.where(valid, wxf * wyf * val, 0.0)
        out.append(acc)
    return torch.cat(out, dim=-1).reshape(b, h, w, -1)


def corr_lookup_onehot_ref(pyramid: Sequence[torch.Tensor],
                           coords: torch.Tensor,
                           radius: int = RADIUS) -> torch.Tensor:
    """The same lookup as one-hot row/column selector contractions (port of
    the JAX ``corr_lookup_onehot``): the ``corr_lookup_impl=onehot`` plain
    path."""
    b, h, w, _ = coords.shape
    p = h * w
    n = 2 * radius + 1
    d10 = torch.arange(n + 1, dtype=torch.float32, device=coords.device)
    cx = coords[..., 0].reshape(b, p)
    cy = coords[..., 1].reshape(b, p)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2], corr.shape[3]
        px0 = cx / (2 ** lvl) - radius
        py0 = cy / (2 ** lvl) - radius
        ix = torch.floor(px0)
        iy = torch.floor(py0)
        ysel = ((iy[..., None] + d10)[..., None] == torch.arange(
            hl, dtype=torch.float32, device=coords.device)).to(corr.dtype)
        xsel = ((ix[..., None] + d10)[..., None] == torch.arange(
            wl, dtype=torch.float32, device=coords.device)).to(corr.dtype)
        t = torch.einsum("bpyh,bphw->bpyw", ysel, corr)
        win = torch.einsum("bpyw,bpxw->bpyx", t, xsel)  # [p, y, x]
        fx = (px0 - ix)[..., None, None]
        fy = (py0 - iy)[..., None, None]
        v = ((1 - fy) * (1 - fx) * win[..., :n, :n]
             + (1 - fy) * fx * win[..., :n, 1:]
             + fy * (1 - fx) * win[..., 1:, :n]
             + fy * fx * win[..., 1:, 1:])
        out.append(v.transpose(-1, -2).reshape(b, p, n * n))
    return torch.cat(out, dim=-1).reshape(b, h, w, -1)


def corr_lookup_proj_ref(pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor,
                         radius: int = RADIUS) -> torch.Tensor:
    """``relu(corr_lookup_gather_ref(pyramid, coords) @ weight + bias)``:
    weight ``(L * (2r+1)^2, C)`` rows in the lookup's channel order, bias
    ``(C,)``. Returns ``(B, H, W, C)``."""
    taps = corr_lookup_gather_ref(pyramid, coords, radius)
    return torch.relu(torch.matmul(taps, weight) + bias)


# ---- CUDA kernels --------------------------------------------------------

def _check_lookup_inputs(pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, radius: int) -> int:
    """Validate what the kernels take; returns the query count Q."""
    if not coords.is_cuda:
        raise ValueError(f"coords on {coords.device}: the CUDA kernels take "
                         "CUDA tensors (CPU tensors use the plain version)")
    if radius != RADIUS or len(pyramid) != LEVELS:
        raise ValueError(f"the CUDA kernels are built for radius {RADIUS} "
                         f"and {LEVELS} levels, got radius {radius} and "
                         f"{len(pyramid)} levels")
    if coords.dtype != torch.float32 or coords.dim() != 4 \
            or coords.shape[-1] != 2 or not coords.is_contiguous():
        raise ValueError("coords must be a contiguous float32 (B, H, W, 2) "
                         f"tensor, got {coords.dtype} {tuple(coords.shape)}")
    b, h, w, _ = coords.shape
    for lvl, corr in enumerate(pyramid):
        if corr.device != coords.device or corr.dtype != torch.float32 \
                or corr.dim() != 4 or tuple(corr.shape[:2]) != (b, h * w) \
                or not corr.is_contiguous():
            raise ValueError(
                f"level {lvl} must be a contiguous float32 (B, P, Hl, Wl) = "
                f"({b}, {h * w}, Hl, Wl) tensor on {coords.device}, got "
                f"{corr.dtype} {tuple(corr.shape)} on {corr.device}")
    return b * h * w


def corr_lookup_level_cuda(pyramid: Sequence[torch.Tensor],
                           coords: torch.Tensor,
                           radius: int = RADIUS) -> torch.Tensor:
    """Per-level lookup kernel: ``(B, H, W, 324)``, the same function as
    :func:`corr_lookup_gather_ref`. One launch per level."""
    if coords.device.type == "cpu":
        return corr_lookup_gather_ref(pyramid, coords, radius)
    q = _check_lookup_inputs(pyramid, coords, radius)
    b, h, w, _ = coords.shape
    out = torch.empty((b, h, w, LEVELS * TAPS), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    lib = build.load()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lvl, corr in enumerate(pyramid):
            err = lib.vft_corr_lookup_level(
                corr.data_ptr(), corr.shape[2], corr.shape[3],
                coords.data_ptr(), q, lvl, out.data_ptr(), LEVELS * TAPS,
                lvl * TAPS, stream)
            build.check(lib, err, "corr_lookup_level_cuda")
            corr_lookup_level_cuda.launches += 1
    return out


corr_lookup_level_cuda.launches = 0


def corr_lookup_proj_cuda(pyramid: Sequence[torch.Tensor],
                          coords: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor,
                          radius: int = RADIUS) -> torch.Tensor:
    """Fused lookup + convc1 kernel: ``(B, H, W, C)`` =
    ``relu(lookup @ weight + bias)``, the same function as
    :func:`corr_lookup_proj_ref`. One launch."""
    if coords.device.type == "cpu":
        return corr_lookup_proj_ref(pyramid, coords, weight, bias, radius)
    q = _check_lookup_inputs(pyramid, coords, radius)
    c_out = weight.shape[-1]
    for name, t, shape in (("weight", weight, (LEVELS * TAPS, c_out)),
                           ("bias", bias, (c_out,))):
        if t.device != coords.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 {shape} tensor on "
                f"{coords.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    b, h, w, _ = coords.shape
    out = torch.empty((b, h, w, c_out), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    lib = build.load()
    args = []
    for corr in pyramid:
        args += [corr.data_ptr(), corr.shape[2], corr.shape[3]]
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vft_corr_lookup_proj(
            *args, coords.data_ptr(), q, weight.data_ptr(), bias.data_ptr(),
            c_out, out.data_ptr(), stream)
        build.check(lib, err, "corr_lookup_proj_cuda")
        corr_lookup_proj_cuda.launches += 1
    return out


corr_lookup_proj_cuda.launches = 0
