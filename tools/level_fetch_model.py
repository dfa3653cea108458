"""A model, not a measurement: what the level kernel's window reads would
cost a card that moves memory in whole ``unit``-byte pieces.

    python3 tools/level_fetch_model.py      # CPU only, about 0.5 GB

``chip_smoke.py``'s bytes bound for ``corr_lookup_level_cuda`` counts only
the in-plane cells of each query's corner windows. The kernel reads each
window as up to 11 rows of an 11-float run, and a run costs the card every
32-byte sector (or 64-byte piece) it touches. For the i3d slice's shapes
and the seeded coords ``chip_smoke.py`` times the kernel on, this prints,
for units of 32 and 64 bytes: the bytes the window rows touch, the same
plus coords and the output, and that total over the 3.35 TB/s of the bound.
Which unit the card really fetches in was not measured: no device counter
of DRAM bytes could be read.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def window_fetch_bytes(shapes, coords, unit: int = 64, side: int = 11,
                       radius: int = 4) -> int:
    """Bytes of the ``unit``-aligned spans that the in-plane runs of every
    query's ``side`` x ``side`` window rows touch, summed over levels, with
    each query's (Hl, Wl) plane contiguous from a ``unit``-aligned level
    base."""
    cx = coords[..., 0].reshape(-1).double()
    cy = coords[..., 1].reshape(-1).double()
    q = torch.arange(cx.numel(), dtype=torch.float64, device=cx.device)
    total = 0
    for lvl, (hl, wl) in enumerate(shapes):
        bx = torch.floor(cx / 2 ** lvl) - radius
        by = torch.floor(cy / 2 ** lvl) - radius
        x0 = torch.clamp(bx, min=0)
        x1 = torch.minimum(bx + side - 1, torch.tensor(wl - 1.0))
        for r in range(side):
            y = by + r
            ok = (y >= 0) & (y < hl) & (x1 >= x0)
            first = (q * hl * wl + y * wl + x0) * 4
            last = (q * hl * wl + y * wl + x1) * 4 + 3
            spans = torch.floor(last / unit) - torch.floor(first / unit) + 1
            total += int(torch.where(ok, spans, 0.0).sum().item()) * unit
    return total


def main() -> int:
    _, _, coords, _ = cs.seeded_lookup(cs.STACK, cs.GRID_H, cs.GRID_W, 0)
    # build_corr_pyramid's avg_pool2d(2, stride 2) floors each side
    shapes = [(cs.GRID_H >> lvl, cs.GRID_W >> lvl) for lvl in range(4)]
    q = coords.shape[0] * cs.GRID_H * cs.GRID_W
    rest = q * 8 + q * 324 * 4  # coords read, taps written
    cells = cs.window_cells(shapes, coords) * 4
    out = {"queries": q, "in_plane_cell_bytes": cells,
           "coords_and_output_bytes": rest,
           "bound_ms": cs.bound(*cs.kernel_work("level", q, cells // 4))[0]}
    for unit in (32, 64):
        read = window_fetch_bytes(shapes, coords, unit)
        out[f"unit_{unit}"] = {
            "read_bytes": read, "total_bytes": read + rest,
            "floor_ms": (read + rest) / cs.HBM_BYTES_PER_S * 1e3}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
