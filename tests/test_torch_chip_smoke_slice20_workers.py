"""chip_smoke.py's step 38 on the CPU at a small size: the slice over four
copies of the sample with ``video_workers`` 1, 2 and ``auto`` and the run
plane and the roofline on. A file of its own beside
tests/test_torch_chip_smoke_slice20_decode.py (steps 35-37), so xdist runs
the two on two workers. The script is imported without running
``main()``; no lookup kernel runs on the CPU, so every count it holds is
0 here."""
import importlib.util
import json
from pathlib import Path

import pytest

from video_features_tpu_torch import cli

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: the decode file's small sizes (tests/test_torch_chip_smoke_slice20_
#: decode.py SMALL: one 10-frame stack, the RGB stream alone) at the
#: slice's two stacks a forward
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1, streams="rgb")
NO_LAUNCH = {"level": 0, "proj": 0, "packed": 0}


@pytest.fixture(scope="module")
def step(tmp_path_factory, sample_video):
    work = tmp_path_factory.mktemp("slice20_workers")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        yield cs.video_workers_phase(video=sample_video,
                                     iters=SMALL["flow_iters"], **SMALL)
    finally:
        mp.undo()


@pytest.mark.parametrize("workers", ["1", "2", "auto"])
def test_video_workers_phase_runs_on_the_cpu(step, workers):
    """Each run: every file bit-equal to the serial run's, one complete
    span a video, a roofline line with every video's dispatch."""
    assert step["videos"] == cs.WORKER_VIDEOS and step["bit_equal_to_serial"]
    run = step["runs"][workers]
    assert run["threads"] == cli._video_workers(workers)
    assert run["spans"] == cs.WORKER_VIDEOS and run["launches"] == NO_LAUNCH
    roof = run["roofline"]
    assert roof["dispatches"] == cs.WORKER_VIDEOS
    assert roof["forward_calls"] == cs.WORKER_VIDEOS - 1
    assert roof["forward_s"] > 0
    json.dumps(step)
