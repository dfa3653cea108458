"""The yardstick of chip_smoke.py on the CPU: the in-plane window cells that
its bytes bound counts, the touched units that tools/level_fetch_model.py
counts, and which of the two bounds each kernel gets at the main paths'
shapes. The scripts are imported without running ``main()``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch



def _load(name, path):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke", "chip_smoke.py")
fetch_model = _load("level_fetch_model", "tools/level_fetch_model.py")

#: a small pyramid: odd sizes, a level narrower than the window, 1x1, 0x0
SHAPES = [(13, 11), (6, 5), (1, 1), (0, 0)]


def _coords():
    """Seeded coords around a 13x11 grid, with whole windows outside the
    plane on every side and some straddling its edges."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-8.0, 20.0, size=(2, 13, 11, 2)).astype(np.float32)
    xy[0, 0] = (-60.0, 5.0)     # far left of every level
    xy[0, 1] = (5.0, 90.0)      # far below
    xy[1, 2, :3] = (-4.5, -4.5)  # straddling the upper-left corner
    return torch.from_numpy(xy)


def _windows(coords, shapes, side):
    """Per query q and level, the in-plane (row, col) cells of the ``side`` x
    ``side`` window from (floor(c / 2^l) - 4), by brute force."""
    for q, (cx, cy) in enumerate(coords.reshape(-1, 2).tolist()):
        for lvl, (hl, wl) in enumerate(shapes):
            x0 = int(np.floor(np.float64(cx) / 2 ** lvl - 4))
            y0 = int(np.floor(np.float64(cy) / 2 ** lvl - 4))
            yield q, lvl, [(y, x) for y in range(y0, y0 + side)
                           for x in range(x0, x0 + side)
                           if 0 <= y < hl and 0 <= x < wl]


def test_window_cells_counts_in_plane_corners():
    coords = _coords()
    want = sum(len(cells) for _, _, cells in _windows(coords, SHAPES, 10))
    assert cs.window_cells(SHAPES, coords) == want
    assert 0 < want < coords.numel() // 2 * len(SHAPES) * 100


def test_window_fetch_bytes_counts_touched_units():
    """Query q's plane starts at q * Hl * Wl floats of its level; each window
    row's in-plane cells cost the 32- or 64-byte units they touch."""
    coords = _coords()
    for unit in (32, 64):
        want = 0
        for q, lvl, cells in _windows(coords, SHAPES, 11):
            hl, wl = SHAPES[lvl]
            for row in {y for y, _ in cells}:
                want += unit * len({(q * hl * wl + y * wl + x) * 4 // unit
                                    for y, x in cells if y == row})
        assert want > 0
        assert fetch_model.window_fetch_bytes(SHAPES, coords, unit) == want


@pytest.mark.parametrize("batch,grid", [(cs.STACK, (cs.GRID_H, cs.GRID_W)),
                                        (cs.RAFT_BATCH,
                                         (cs.RAFT_GRID_H, cs.RAFT_GRID_W))])
def test_bound_picks_operations_for_proj_and_bytes_for_level(batch, grid):
    """From shapes alone: proj is bound by its float32 FMAs even if every
    window cell of every level were read; level by its bytes even if no
    cell were."""
    q = batch * grid[0] * grid[1]
    assert cs.bound(*cs.kernel_work("proj", q, q * 4 * 100))[1] == \
        "operations"
    level_ms, by = cs.bound(*cs.kernel_work("level", q, 0))
    assert by == "bytes"
    # the output alone: 324 floats a query over the card's memory rate
    assert level_ms >= q * 324 * 4 / cs.HBM_BYTES_PER_S * 1e3


def test_max_abs_err_passes_equal_nan_layouts():
    want = torch.tensor([[1.0, float("nan"), 3.0], [float("nan"), 0.5, 0.0]])
    got = want.clone()
    got[0, 0] += 2.0 ** -19  # exact in float32
    assert cs.max_abs_err(got, want) == 2.0 ** -19
    assert cs.max_abs_err(want, want) == 0.0
    every = torch.full((2, 3), float("nan"))
    assert cs.max_abs_err(every, every) == 0.0


@pytest.mark.parametrize("where", ["got", "want"])
def test_max_abs_err_fails_a_nan_in_one_place_only(where):
    want = torch.tensor([1.0, float("nan"), 3.0])
    got = want.clone()
    (got if where == "got" else want)[2] = float("nan")
    assert not cs.max_abs_err(got, want) <= 1e-5


def test_ragged_phase_runs_its_cases_on_the_cpu():
    """On the CPU every wrapper takes its plain version, so the phase holds
    each plain version against itself: every case runs, the ``nonfinite``
    one included (NaN, +-inf and +-1e30 coords), with no error."""
    _, coords = cs.ragged_inputs(torch.device("cpu"), "nonfinite")
    assert torch.isnan(coords).sum() == 2 and torch.isinf(coords).sum() == 2
    errs = cs.check_ragged(torch.device("cpu"))
    assert set(errs) == {"q231", "odd", "outside", "degenerate", "nonfinite"}
    for e in errs.values():
        assert e["level"] == e["proj"] == e["packed"] == 0.0


def test_pwc_levels_are_the_models_pyramid_at_256x384():
    """The cost volume's timing shapes are PWCNet's decoder levels for the
    i3d phase's frames: 240x320 resized to 256x341, then to /64 multiples
    (256x384) inside the net."""
    from video_features_tpu_torch.models import pwc
    assert (-(-341 // 64) * 64, -(-256 // 64) * 64) == (384, 256)
    with torch.inference_mode():
        feats = pwc.Extractor()(torch.zeros((1, 3, 256, 384)))
    for level, h, w, c in cs.PWC_LEVELS:
        assert tuple(feats[level - 1].shape[1:]) == (c, h, w), level
    assert [lv for lv, *_ in cs.PWC_LEVELS] == [lv for lv, _ in
                                                 sorted(pwc.LEVELS)]


def test_annotated_wraps_and_restores():
    """The profiler ranges wrap a module's functions by name, keep their
    results, and put the originals back."""
    import types
    mod = types.SimpleNamespace(f=lambda x: x + 1, g=lambda x: 2 * x)
    f, g = mod.f, mod.g
    undo = cs.annotated(mod, ["f", "g"])
    assert mod.f is not f and mod.f(1) == 2 and mod.g(3) == 6
    undo()
    assert mod.f is f and mod.g is g


def test_band_is_cosine_and_max_abs():
    a = np.array([1.0, 2.0, 2.0], np.float32)
    assert cs.band(a, a) == {"cos": pytest.approx(1.0), "max_abs": 0.0}
    got = cs.band(a + np.array([0.0, 0.0, 0.5], np.float32), a)
    assert got["max_abs"] == 0.5 and 0.99 < got["cos"] < 1.0
