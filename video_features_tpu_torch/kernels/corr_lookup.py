"""RAFT correlation-pyramid lookup: CUDA kernels and their plain versions.

Port of ``video_features_tpu/kernels/corr_lookup.py``. Three kernels,
written by hand for Hopper in ``csrc/corr_lookup.cu`` (design notes and what
bounds each on the card are in that file):

  - :func:`corr_lookup_level_cuda` replaces ``_level_kernel`` (launched by
    ``corr_lookup_level_pallas``, API ``corr_lookup_pallas``): the 81-tap
    bilinear window of every level, all four levels in one launch, into the
    ``(B, H, W, 324)`` output;
  - :func:`corr_lookup_proj_cuda` replaces ``_proj_kernel`` (launched by
    ``_corr_lookup_proj_flat``, API ``corr_lookup_proj``): all four levels
    and RAFT's motion-encoder ``convc1``, ``relu(lookup @ W + b)`` with
    ``C = 256`` output channels, one launch per GRU iteration;
  - :func:`corr_lookup_packed_cuda` replaces ``_packed_kernel`` (launched by
    ``_corr_lookup_packed_flat``, API ``corr_lookup_packed``): the same 324
    taps as the level kernel, all four levels in one launch, read from the
    lane-dense packed plane of :func:`pack_pyramid`.

The first two take the unpadded pyramid levels ``(B, P, Hl, Wl)`` as
:func:`video_features_tpu_torch.models.raft.build_corr_pyramid` returns them
(the pair batch folds into ``Q = B * P`` queries) and coords ``(B, H, W, 2)``
as level-0 (x, y). The TPU kernels' 8x128 tile padding and one-hot /
hat-function selector matmuls were workarounds for Mosaic's missing gather;
the CUDA kernels read the four bilinear corners directly. The packed layout
is kept as the JAX package defines it (byte for byte), because
``corr_lookup_impl=packed`` names it; its kernel reads the corners through
the layout's address map instead of the TPU's group select.

Beside each kernel is its plain PyTorch version, :func:`corr_lookup_gather_ref`
(``torch.gather``), :func:`corr_lookup_proj_ref` (the same plus one
``torch.matmul``) and :func:`corr_lookup_packed_ref` (``torch.gather`` on
the packed plane through the same address map as the kernel). A wrapper
takes the plain version only for a CPU tensor; for a CUDA tensor it launches
its kernel or raises. Each wrapper counts its kernel launches in a plain
integer attribute, ``launches``, bumped under a module lock
(:func:`count_launch`) so that concurrent ``video_workers`` threads lose
none. A NaN or infinite coord gives what the JAX
counterpart gives: zeros from the gather (``relu(bias)`` from the
projection), NaN from the packed lookup, whose weights ``c - floor(c)`` are
NaN; kernel and plain version agree.

The declared work of each op, :func:`kernel_work` (the bytes it must move
and the operations it must do), is the one count of it in the repository:
``chip_smoke.py`` bounds each kernel's time with it, and each kernel's
wrapper and plain version report it to the roofline counter
(``telemetry/roofline.py``) through :data:`work_hook`, whichever of the two
runs, so that a roofline card counted on the CPU equals one counted on the
card. The roofline's counting pass sees neither the kernels (they are
reached through ``ctypes``, not the dispatcher) nor, by the same hook, the
plain versions' own aten ops. With roofline accounting off the hook is None
and costs each call one global read.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

RADIUS = 4
LEVELS = 4
TAPS = (2 * RADIUS + 1) ** 2

#: the H100 SXM's float32 rate outside the tensor cores and its HBM rate
#: (NVIDIA's data sheet): the peaks the kernels' bounds are taken against
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


# ---- declared work ---------------------------------------------------------

def kernel_work(kernel: str, q: int, cells: int, c_out: int = 256
                ) -> Tuple[int, int]:
    """(bytes, operations) the ``kernel`` (``level``, ``proj`` or
    ``packed``) must move and do for ``q`` queries whose corner windows hold
    ``cells`` in-plane cells: each input read once (the cells, coords; W and
    b for proj), each output written once (324 taps, or ``c_out`` channels
    for proj); 12 operations per tap (4 corner weights, 4 products, 4 adds)
    plus proj's 2 x 324 x ``c_out`` per query."""
    taps = q * LEVELS * TAPS
    read = cells * 4 + q * 8
    if kernel == "proj":
        return (read + (LEVELS * TAPS + 1) * c_out * 4 + q * c_out * 4,
                2 * taps * c_out + taps * 12)
    return read + taps * 4, taps * 12


def declared_cells(shapes: Sequence[Tuple[int, int]], q: int,
                   radius: int = RADIUS) -> int:
    """The most in-plane cells ``q`` queries' (2r+2)^2 corner windows can
    hold over levels of ``shapes`` ((Hl, Wl) each): the shape-only count of
    :func:`kernel_work`'s ``cells`` that a roofline card takes (the count of
    a run's own coords, which needs their values, is ``chip_smoke.py
    window_cells``)."""
    n = 2 * radius + 2
    return q * sum(min(n, hl) * min(n, wl) for hl, wl in shapes)


#: ``work_hook(name, nbytes, operations)``, installed by the roofline
#: observer while it is active (``telemetry/roofline.py``); None when
#: roofline accounting is off. It returns a context manager inside which
#: the counter leaves the aten ops it sees out.
work_hook: Optional[Callable] = None

_NO_HOOK = contextlib.nullcontext()


def _declared(hook: Optional[Callable], name: str, kernel: str,
              shapes: Sequence[Tuple[int, int]], coords: torch.Tensor,
              c_out: int = 256):
    """``hook``'s context for ``kernel``'s declared work at these shapes,
    or a no-op context when ``hook`` is None."""
    if hook is None:
        return _NO_HOOK
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    return hook(name, *kernel_work(kernel, q, declared_cells(shapes, q),
                                   c_out))


def _shapes(pyramid: Sequence[torch.Tensor]) -> List[Tuple[int, int]]:
    return [tuple(c.shape[2:]) for c in pyramid]


# ---- plain versions ------------------------------------------------------

def corr_lookup_gather_ref(pyramid: Sequence[torch.Tensor],
                           coords: torch.Tensor,
                           radius: int = RADIUS) -> torch.Tensor:
    """Windowed bilinear lookup (reference corr.py:29-50) with
    ``torch.gather``: pyramid per level ``(B, P, Hl, Wl)``, coords
    ``(B, H, W, 2)`` level-0 (x, y). Returns ``(B, H, W, L * (2r+1)^2)``,
    per level the x-offset varying slowest, zeros outside the plane."""
    hook = work_hook
    with _declared(hook, "corr_lookup_gather_ref", "level",
                   _shapes(pyramid) if hook else (), coords):
        return _gather(pyramid, coords, radius)


def _gather(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
            radius: int) -> torch.Tensor:
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
                # the index only from in-range corners: a non-finite coord
                # would cast to an index out of bounds
                idx = torch.where(valid, yi * wl + xi, 0.0).to(torch.int64)
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
    hook = work_hook
    with _declared(hook, "corr_lookup_proj_ref", "proj",
                   _shapes(pyramid) if hook else (), coords,
                   weight.shape[-1]):
        taps = _gather(pyramid, coords, radius)
        return torch.relu(torch.matmul(taps, weight) + bias)


# ---- lane-dense packed pyramid -------------------------------------------

class LevelMeta(NamedTuple):
    """Packing geometry of one pyramid level (the JAX ``LevelMeta``)."""
    hl: int   # image rows
    wl: int   # image cols
    j: int    # rows packed per 128-lane line
    g: int    # row groups, ceil(hl / j)
    k: int    # packed lane width of a group, j * wl rounded up to 128
    off: int = 0  # lane offset of this level in the packed (Q, K_total) plane


def plan_level(hl: int, wl: int) -> LevelMeta:
    """The JAX ``_plan_level``: ``j = min(hl, max(1, 128 // wl))`` rows per
    group, ``g = ceil(hl / j)`` groups of ``k = ceil(j * wl / 128) * 128``
    lanes; a 0x0 level is a one-line placeholder of zeros."""
    if hl == 0 or wl == 0:
        return LevelMeta(0, 0, 1, 1, 128)
    j = min(hl, max(1, 128 // wl))
    g = -(-hl // j)
    k = -(-(j * wl) // 128) * 128
    return LevelMeta(hl, wl, j, g, k)


def pack_level(corr: torch.Tensor) -> Tuple[torch.Tensor, LevelMeta]:
    """``(B, P, Hl, Wl)`` level -> ``((B*P, G*K) plane, meta)``: row group
    ``r // j`` of query q lives in lanes ``[(r // j) * K, ...)``, sub-row
    ``r % j`` at ``(r % j) * Wl`` within it. Phantom rows of the last group
    and the lane tail beyond ``j * Wl`` are zero."""
    b, p, hl, wl = corr.shape
    m = plan_level(hl, wl)
    if m.hl == 0:
        return corr.new_zeros((b * p, m.g * m.k)), m
    x = corr.reshape(b * p, hl, wl)
    x = F.pad(x, (0, 0, 0, m.g * m.j - hl))
    x = F.pad(x.reshape(b * p, m.g, m.j * wl), (0, m.k - m.j * wl))
    return x.reshape(b * p, m.g * m.k), m


def pack_pyramid(pyramid: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Tuple[LevelMeta, ...]]:
    """All levels -> one ``(B*P, K_total)`` plane and the per-level metas
    with their lane offsets (the JAX ``pack_pyramid``, byte for byte). RAFT
    packs once per forward, before the GRU loop."""
    packed, metas = zip(*(pack_level(c) for c in pyramid))
    offs, off = [], 0
    for m in metas:
        offs.append(m._replace(off=off))
        off += m.g * m.k
    return torch.cat(packed, dim=1), tuple(offs)


def corr_lookup_packed_ref(packed: torch.Tensor,
                           metas: Sequence[LevelMeta],
                           coords: torch.Tensor,
                           radius: int = RADIUS) -> torch.Tensor:
    """The packed kernel's function in plain torch: ``(B, H, W, L*(2r+1)^2)``
    taps read from ``packed (Q, K_total)`` through the layout's address map,
    row ``r`` at lane ``off + (r // j) * k + (r % j) * wl + x``; a corner with
    ``r`` outside ``[0, hl)`` or ``x`` outside ``[0, wl)`` is zero. Per level
    the x-offset is slowest; the blend order is the JAX ``_packed_kernel``'s
    (``(1-fx)(1-fy)``, ``fx(1-fy)``, ``(1-fx)fy``, ``fx fy``)."""
    hook = work_hook
    with _declared(hook, "corr_lookup_packed_ref", "packed",
                   [(m.hl, m.wl) for m in metas] if hook else (), coords):
        return _packed(packed, metas, coords, radius)


def _packed(packed: torch.Tensor, metas: Sequence[LevelMeta],
            coords: torch.Tensor, radius: int) -> torch.Tensor:
    b, h, w, _ = coords.shape
    q = b * h * w
    n = 2 * radius + 1
    d = torch.arange(n, dtype=torch.float32, device=coords.device)
    cx = coords[..., 0].reshape(q, 1, 1)
    cy = coords[..., 1].reshape(q, 1, 1)
    out = []
    for lvl, m in enumerate(metas):
        if m.hl == 0:  # a level pooled to nothing: all taps are zeros
            out.append(torch.zeros((q, n * n), dtype=torch.float32,
                                   device=coords.device))
            continue
        px0 = cx * (1.0 / (1 << lvl)) - radius
        py0 = cy * (1.0 / (1 << lvl)) - radius
        ix = torch.floor(px0)
        iy = torch.floor(py0)
        fx = px0 - ix
        fy = py0 - iy
        xs = ix + d.view(1, n, 1)  # window column of tap (xx, .)
        ys = iy + d.view(1, 1, n)  # window row of tap (., yy)

        def corner(dx: int, dy: int) -> torch.Tensor:
            x, r = xs + dx, ys + dy
            x_in = (x >= 0) & (x <= m.wl - 1)
            r_in = (r >= 0) & (r <= m.hl - 1)
            valid = x_in & r_in
            # the lane only from in-range columns and rows (a non-finite
            # coord would cast to an index out of bounds); the weights keep
            # its NaN
            xi = torch.where(x_in, x, 0.0).to(torch.int64)
            ri = torch.where(r_in, r, 0.0).to(torch.int64)
            lane = m.off + (ri // m.j) * m.k + (ri % m.j) * m.wl + xi
            val = torch.gather(packed, 1, lane.reshape(q, n * n))
            return torch.where(valid, val.reshape(q, n, n), 0.0)

        v = ((1 - fx) * (1 - fy) * corner(0, 0)
             + fx * (1 - fy) * corner(1, 0)
             + (1 - fx) * fy * corner(0, 1)
             + fx * fy * corner(1, 1))
        out.append(v.reshape(q, n * n))
    return torch.cat(out, dim=-1).reshape(b, h, w, -1)


# ---- CUDA kernels --------------------------------------------------------

def _check_coords(coords: torch.Tensor, radius: int, levels: int) -> int:
    """Validate the coords and geometry every kernel takes; returns the
    query count Q."""
    if not coords.is_cuda:
        raise ValueError(f"coords on {coords.device}: the CUDA kernels take "
                         "CUDA tensors (CPU tensors use the plain version)")
    if radius != RADIUS or levels != LEVELS:
        raise ValueError(f"the CUDA kernels are built for radius {RADIUS} "
                         f"and {LEVELS} levels, got radius {radius} and "
                         f"{levels} levels")
    if coords.dtype != torch.float32 or coords.dim() != 4 \
            or coords.shape[-1] != 2 or not coords.is_contiguous():
        raise ValueError("coords must be a contiguous float32 (B, H, W, 2) "
                         f"tensor, got {coords.dtype} {tuple(coords.shape)}")
    b, h, w, _ = coords.shape
    return b * h * w


def _check_lookup_inputs(pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, radius: int) -> int:
    """Validate what the level and proj kernels take; returns the query
    count Q."""
    q = _check_coords(coords, radius, len(pyramid))
    b, h, w, _ = coords.shape
    for lvl, corr in enumerate(pyramid):
        if corr.device != coords.device or corr.dtype != torch.float32 \
                or corr.dim() != 4 or tuple(corr.shape[:2]) != (b, h * w) \
                or not corr.is_contiguous():
            raise ValueError(
                f"level {lvl} must be a contiguous float32 (B, P, Hl, Wl) = "
                f"({b}, {h * w}, Hl, Wl) tensor on {coords.device}, got "
                f"{corr.dtype} {tuple(corr.shape)} on {corr.device}")
    return q


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper: Callable) -> None:
    """``wrapper.launches += 1`` as one step under the module lock (the
    read-modify-write alone loses counts between threads)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def _level_args(pyramid: Sequence[torch.Tensor]) -> list:
    """(pointer, Hl, Wl) of each level, as the C entry points take them."""
    args = []
    for corr in pyramid:
        args += [corr.data_ptr(), corr.shape[2], corr.shape[3]]
    return args


def corr_lookup_level_cuda(pyramid: Sequence[torch.Tensor],
                           coords: torch.Tensor,
                           radius: int = RADIUS) -> torch.Tensor:
    """Lookup kernel: ``(B, H, W, 324)``, the same function as
    :func:`corr_lookup_gather_ref`. One launch for all four levels."""
    if coords.device.type == "cpu":
        return corr_lookup_gather_ref(pyramid, coords, radius)
    q = _check_lookup_inputs(pyramid, coords, radius)
    b, h, w, _ = coords.shape
    out = torch.empty((b, h, w, LEVELS * TAPS), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    lib = build.load()
    hook = work_hook
    with torch.cuda.device(coords.device), _declared(
            hook, "corr_lookup_level_cuda", "level",
            _shapes(pyramid) if hook else (), coords):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vft_corr_lookup_level(*_level_args(pyramid),
                                        coords.data_ptr(), q, out.data_ptr(),
                                        stream)
        build.check(lib, err, "corr_lookup_level_cuda")
        count_launch(corr_lookup_level_cuda)
    return out


corr_lookup_level_cuda.launches = 0


#: convc1's output channels, the only width the fused kernel takes
PROJ_C_OUT = 256


def corr_lookup_proj_cuda(pyramid: Sequence[torch.Tensor],
                          coords: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor,
                          radius: int = RADIUS) -> torch.Tensor:
    """Fused lookup + convc1 kernel: ``(B, H, W, C)`` =
    ``relu(lookup @ weight + bias)``, the same function as
    :func:`corr_lookup_proj_ref`. One launch. On the card ``C`` must be
    :data:`PROJ_C_OUT` (RAFT's convc1) and weight and bias 16-byte aligned,
    else ``ValueError``."""
    if coords.device.type == "cpu":
        return corr_lookup_proj_ref(pyramid, coords, weight, bias, radius)
    q = _check_lookup_inputs(pyramid, coords, radius)
    c_out = weight.shape[-1]
    if c_out != PROJ_C_OUT:
        raise ValueError(f"the CUDA proj kernel takes {PROJ_C_OUT} output "
                         f"channels (RAFT's convc1), got {c_out}")
    for name, t, shape in (("weight", weight, (LEVELS * TAPS, c_out)),
                           ("bias", bias, (c_out,))):
        if t.device != coords.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be a contiguous, 16-byte aligned float32 "
                f"{shape} tensor on {coords.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    b, h, w, _ = coords.shape
    out = torch.empty((b, h, w, c_out), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    lib = build.load()
    hook = work_hook
    with torch.cuda.device(coords.device), _declared(
            hook, "corr_lookup_proj_cuda", "proj",
            _shapes(pyramid) if hook else (), coords, c_out):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vft_corr_lookup_proj(
            *_level_args(pyramid), coords.data_ptr(), q, weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), stream)
        build.check(lib, err, "corr_lookup_proj_cuda")
        count_launch(corr_lookup_proj_cuda)
    return out


corr_lookup_proj_cuda.launches = 0


def corr_lookup_packed_cuda(packed: torch.Tensor,
                            metas: Sequence[LevelMeta],
                            coords: torch.Tensor,
                            radius: int = RADIUS) -> torch.Tensor:
    """Packed lookup kernel: ``(B, H, W, 324)``, the same function as
    :func:`corr_lookup_packed_ref`, bit for bit, NaN where a coord is not
    finite (and, on finite coords, as :func:`corr_lookup_gather_ref` on the
    unpacked levels within float32 rounding). One launch for all four
    levels: a warp stages the 10x10 corner cells of 4 queries per level in
    shared memory through the layout's address map, blends each query's 81
    taps with its four shared weights and writes the 4 rows as whole lines.
    Bound by bytes: the window cells read and the taps written. No size
    gate: the JAX ``fused_lookup_supported`` limit (``G <= 16``, 2 MiB per
    query) is the TPU's VMEM envelope, and this kernel reads device memory
    directly."""
    if coords.device.type == "cpu":
        return corr_lookup_packed_ref(packed, metas, coords, radius)
    q = _check_coords(coords, radius, len(metas))
    b, h, w, _ = coords.shape
    k_total = sum(m.g * m.k for m in metas)
    if packed.device != coords.device or packed.dtype != torch.float32 \
            or tuple(packed.shape) != (q, k_total) \
            or not packed.is_contiguous():
        raise ValueError(
            f"packed must be a contiguous float32 ({q}, {k_total}) tensor on "
            f"{coords.device}, got {packed.dtype} {tuple(packed.shape)} on "
            f"{packed.device}")
    out = torch.empty((b, h, w, LEVELS * TAPS), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    lib = build.load()
    geometry = (ctypes.c_int * (5 * LEVELS))(
        *(v for m in metas for v in (m.hl, m.wl, m.j, m.k, m.off)))
    hook = work_hook
    with torch.cuda.device(coords.device), _declared(
            hook, "corr_lookup_packed_cuda", "packed",
            [(m.hl, m.wl) for m in metas] if hook else (), coords):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vft_corr_lookup_packed(
            packed.data_ptr(), k_total, coords.data_ptr(), q, geometry,
            out.data_ptr(), stream)
        build.check(lib, err, "corr_lookup_packed_cuda")
        count_launch(corr_lookup_packed_cuda)
    return out


corr_lookup_packed_cuda.launches = 0
