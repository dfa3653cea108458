"""chip_smoke.py's steps 31-34 on the CPU at a small size: the slice over a
re-encoded video (``fps_mode=reencode``), weights resolved from a
``VFT_WEIGHTS_DIR``, the native ``.npy`` writer on the main path, and the
port's lint over the checkout. A file of its own beside the other
chip-smoke test files, whose module fixtures already take minutes each on
one xdist worker. The script is imported without running ``main()``; no
lookup kernel runs on the CPU, so every count it holds is 0 here."""
import importlib.util
import json
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: the CPU's small sizes of the slice (tests/test_torch_chip_smoke_run_plane
#: .py SMALL): one 10-frame stack, 2 RAFT iterations
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1)
ITERS = SMALL["flow_iters"]
NO_LAUNCH = {"level": 0, "proj": 0, "packed": 0}


@pytest.fixture(scope="module")
def steps(tmp_path_factory, sample_video):
    """Steps 31-34 in one working directory, in the order ``main`` runs
    them."""
    work = tmp_path_factory.mktemp("slice19")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        yield dict(
            reencode=cs.reencode_phase(video=sample_video, iters=ITERS,
                                       **SMALL),
            weights=cs.weights_phase(video=sample_video, iters=ITERS,
                                     **SMALL),
            native=cs.native_phase(video=sample_video, iters=ITERS, **SMALL),
            lint=cs.lint_phase(), work=work)
    finally:
        mp.undo()


def test_reencode_phase_runs_on_the_cpu(steps):
    """The re-encoded sample at 1 fps: select's 18 frames and timestamps,
    one stack, no launch off the card, the temp file gone."""
    stats = steps["reencode"]
    assert stats["backend"] == "cv2"  # no ffmpeg on this box
    assert stats["frames"] == stats["select_frames"] == 18
    assert stats["stacks"] == 1 and stats["launches"] == NO_LAUNCH
    assert not list(Path(steps["work"]).rglob("*_new_fps.mp4"))
    json.dumps(stats)


def test_weights_phase_runs_on_the_cpu(steps):
    """The store's resolution bit-equal to the explicit paths, both cache
    entries keyed by the three files' fingerprint, and the empty
    directory's refusal naming it."""
    stats = steps["weights"]
    assert stats["files"] == ["i3d_rgb.pt", "i3d_flow.pt", "raft-sintel.pth"]
    assert "No weights for 'i3d_rgb'" in stats["refusal"]
    assert set(stats["launches"]) == {"explicit", "weights_dir"}
    assert all(v == NO_LAUNCH for v in stats["launches"].values())
    assert stats["outputs"] == 4
    json.dumps(stats)


def test_native_phase_runs_on_the_cpu(steps):
    """Every .npy of the run through the native writer, byte-equal to
    np.save, a torn copy flagged."""
    stats = steps["native"]
    assert stats["available"] and stats["native_writes"] == 4
    assert len(stats["files"]) == 4 and stats["launches"] == NO_LAUNCH
    json.dumps(stats)


def test_lint_phase_runs_on_the_cpu(steps):
    stats = steps["lint"]
    assert stats["counts"]["errors"] == 0 and stats["findings"] == 0
    assert stats["counts"]["suppressed"] >= 1
    json.dumps(stats)
