"""chip_smoke.py's steps 35-37 on the CPU at a small size: the slice with
spawned decode (``video_decode=process|parallel``) against inline, the
decode ladder under an injected read fault armed in the children through
``VFT_INJECT``, and the deadline watchdog over a video whose decode stalls.
A file of its own beside the other chip-smoke test files, whose module
fixtures take minutes each on one xdist worker; step 38 is in
tests/test_torch_chip_smoke_slice20_workers.py. The script is imported
without running ``main()``; no lookup kernel runs on the CPU, so every
count it holds is 0 here."""
import contextlib
import importlib.util
import io as io_
import json
from pathlib import Path

import pytest

from video_features_tpu.utils import faults as jfaults
from video_features_tpu.utils import inject as jinject
from video_features_tpu.utils import io as jio
from video_features_tpu.utils import sinks as jsinks
from video_features_tpu_torch.utils import faults as tfaults
from video_features_tpu_torch.utils import inject as tinject
from video_features_tpu_torch.utils import io as tio
from video_features_tpu_torch.utils import sinks as tsinks

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: the CPU's small sizes of the slice: one 10-frame stack at 1 fps, one
#: stack a forward (the deadline step's stalled video sends its stack to
#: the device before its decode stalls), the RGB stream alone: these steps
#: hold the host paths, and RAFT over a 10-frame stack takes 10-15 s on
#: the one thread an xdist worker gets
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1, clip_batch_size=1, streams="rgb")
ITERS = SMALL["flow_iters"]
NO_LAUNCH = {"level": 0, "proj": 0, "packed": 0}
#: the CPU's deadlines: several times the clean video's attempt at SMALL
#: (1-3 s inline on one busy thread; a spawned child adds its start), so
#: that only the stalled video's attempt expires
DEADLINES = {"inline": 8.0, "process": 15.0}


@pytest.fixture(scope="module")
def steps(tmp_path_factory, sample_video):
    """Steps 35-37 in one working directory, in the order ``main`` runs
    them (the ladder and the deadline read step 35's inline run)."""
    work = tmp_path_factory.mktemp("slice20_decode")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        spawned = cs.spawned_decode_phase(video=sample_video, iters=ITERS,
                                          **SMALL)
        yield dict(
            spawned=spawned,
            ladder=cs.ladder_phase(video=sample_video, iters=ITERS,
                                   **SMALL),
            deadline=cs.deadline_phase(video=sample_video, iters=ITERS,
                                       deadlines=DEADLINES, **SMALL),
            work=work)
    finally:
        mp.undo()


def test_spawned_decode_phase_runs_on_the_cpu(steps):
    """process and parallel decode give inline's frames and features; one
    child a process source, two a parallel one, every one reaped."""
    modes = steps["spawned"]["modes"]
    assert {m: modes[m]["children"] for m in modes} == {
        "inline": 0, "process": 2, "parallel": 4}
    for stats in modes.values():
        assert stats["unreaped"] == 0 and stats["children_on_card"] == 0
        assert stats["launches"] == NO_LAUNCH and stats["stacks"] == 1
        assert stats["frames"] == modes["inline"]["frames"] == 18
    json.dumps(steps["spawned"])


def test_ladder_phase_runs_on_the_cpu(steps):
    """Both runs demote parallel -> process -> inline; with 3 attempts the
    journal holds the one record the card's run holds, with 4 the video is
    recovered bit-equal to the clean run."""
    ladder = steps["ladder"]
    three, four = ladder["attempts3"], ladder["attempts4"]
    assert three["demotions"] == four["demotions"] == ["process", "inline"]
    assert three["journal"] == [cs.ladder_record(3)]
    assert three["outputs"] == 0 and not three["recovered"]
    assert four["journal"] == [] and four["recovered"]
    assert three["children"] == four["children"] == 3
    assert three["unreaped"] == four["unreaped"] == 0
    json.dumps(ladder)


def test_deadline_phase_runs_on_the_cpu(steps):
    """The stalled copy fails on the watchdog, inline and under process,
    and leaves no .npy; the sample after it is bit-equal to its run
    alone."""
    for mode, stats in steps["deadline"].items():
        assert stats["expirations"] == 1 and stats["npy_left"] == 0
        assert stats["stopped_child_state"] == (
            ["T"] if mode == "process" else [])
        assert stats["unreaped"] == len(stats["stopped_child_state"])
        assert stats["journal"] == {"category": "TRANSIENT", "attempts": 1}
        assert stats["error"].startswith("DeadlineExceeded")
        assert stats["next_video_bit_equal"]
        assert stats["children"] == (2 if mode == "process" else 0)
        assert stats["launches"] == NO_LAUNCH
    assert not list(Path(steps["work"]).rglob(f"*{cs.STALL_TAG}_*.npy"))
    json.dumps(steps["deadline"])


@pytest.mark.parametrize("attempts", [2, 3])
def test_ladder_from_process_matches_jax(sample_video, tmp_path, monkeypatch,
                                         attempts):
    """Each package's ``safe_extract`` over its own decode sources from
    ``video_decode=process``, the ladder's plan armed in this process and
    in the decode child through ``VFT_INJECT``: the same rungs, the same
    status and the same journal records. The child's third read fails the
    process rung; the inline rung's third read is this process's, so with
    2 attempts the video fails with the record of step 36's 3 attempts
    (``chip_smoke.ladder_record``), and with 3 it is recovered inline.
    (From ``parallel`` the packages part: the JAX package's segment
    workers decode through ``cv2`` directly, past the ``decode.read``
    site, ROADMAP.md Queue 3.)"""
    monkeypatch.setenv("VFT_INJECT", cs.LADDER_INJECT)
    seen = {}
    for name, faults, inject, io, sinks in (
            ("jax", jfaults, jinject, jio, jsinks),
            ("port", tfaults, tinject, tio, tsinks)):
        inject.arm_for_run(None)
        modes = []

        def extract(path, faults=faults, io=io, modes=modes):
            mode = faults.current_context().decode_override or "process"
            modes.append(mode)
            cls = (io.ProcessVideoSource if mode == "process"
                   else io.VideoSource)
            src = cls(path, fps=SMALL["extraction_fps"])
            return {"n": len(list(src.frames()))}

        journal = faults.FailureJournal(tmp_path / name)
        policy = faults.RetryPolicy(attempts=attempts, backoff_s=0.0)
        try:
            with contextlib.redirect_stdout(io_.StringIO()), \
                    contextlib.redirect_stderr(io_.StringIO()):
                status = sinks.safe_extract(extract, sample_video,
                                            policy=policy, journal=journal,
                                            decode_mode="process")
        finally:
            monkeypatch.delenv("VFT_INJECT")
            inject.disarm()
            monkeypatch.setenv("VFT_INJECT", cs.LADDER_INJECT)
        records = [{k: r[k] for k in ("category", "attempts", "error")}
                   for r in journal.load().values()]
        seen[name] = (status, modes, records)
    want = {2: ("error", ["process", "inline"], [cs.ladder_record(2)]),
            3: ("done", ["process", "inline", "inline"], [])}[attempts]
    assert seen["port"] == seen["jax"] == want
