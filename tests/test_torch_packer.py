"""Cross-video clip batching: the port's ``parallel/packer.py`` against the
JAX package's (tests/test_packer.py), and the r21d CLI with
``cross_video_batching=true``.

- JAX's own cases (``FakeRunner``, ``PoisonRunner``, ``_FailsOnArray``, a
  dispatch that raises, mismatched clip shapes) run against both packers,
  which give the same rows and poison the same videos;
- the port's packer over a ``DataParallelApply`` of 2 CPU replicas gives
  each video its own rows in clip order, groups full but the last;
- the port CLI, r21d on 3 short videos (1, 2 and 2 clips) and an
  unreadable one, ``cross_video_batching=true video_workers=2
  mesh_devices=2`` and ``clip_batch_size=2``: the broken video fails
  alone, the others equal the unpacked single-worker run (within 1e-6: on
  the CPU a convolution of another batch size may sum in another order)
  and are within the value tier (atol 1e-2) of the JAX CLI with the same
  keys on the same seeded checkpoint.
"""
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from video_features_tpu.parallel.packer import ClipPacker as JClipPacker
from video_features_tpu_torch.parallel.mesh import DataParallelApply, get_mesh
from video_features_tpu_torch.parallel.packer import ClipPacker

PACKERS = {"jax": JClipPacker, "port": ClipPacker}


class FakeRunner:
    """JAX's: a row-wise 'device' forward (the mean over all but the
    leading axis) with a jitter delay, recording each group's size."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.groups = []

    def dispatch(self, group: np.ndarray) -> np.ndarray:
        if self.delay:
            time.sleep(self.delay)
        self.groups.append(group.shape[0])
        return group.reshape(group.shape[0], -1).mean(axis=1, keepdims=True)


class _FailsOnArray:
    """A device buffer whose blocking read raises."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("device exploded during D2H")


class PoisonRunner(FakeRunner):
    """The ``fail_group``-th group fails at materialization."""

    def __init__(self, fail_group: int):
        super().__init__()
        self.fail_group = fail_group

    def dispatch(self, group: np.ndarray) -> np.ndarray:
        gi = len(self.groups)
        out = super().dispatch(group)
        return _FailsOnArray() if gi == self.fail_group else out


def _stack(video: int, idx: int) -> np.ndarray:
    return np.full((4, 8, 8, 3), float(video * 1000 + idx), np.float32)


@pytest.fixture(params=sorted(PACKERS))
def packer_cls(request):
    return PACKERS[request.param]


def test_single_video_ragged_flush(packer_cls):
    runner = FakeRunner()
    p = packer_cls(runner, batch=8)
    h = p.open_video()
    for i in range(3):
        p.add(h, _stack(0, i))
    rows = p.close_video(h)
    np.testing.assert_array_equal(rows[:, 0], [0.0, 1.0, 2.0])
    assert runner.groups == [3]


def test_groups_fill_across_videos_and_empty_video(packer_cls):
    runner = FakeRunner()
    p = packer_cls(runner, batch=4)
    h1, h2, h3 = p.open_video(), p.open_video(), p.open_video()
    for i in range(2):
        p.add(h1, _stack(1, i))
        p.add(h2, _stack(2, i))
    assert runner.groups == [4]
    assert p.close_video(h3).shape == (0,)
    np.testing.assert_array_equal(p.close_video(h1)[:, 0], [1000.0, 1001.0])
    np.testing.assert_array_equal(p.close_video(h2)[:, 0], [2000.0, 2001.0])


def test_abort_unwedges_closers(packer_cls):
    runner = FakeRunner()
    p = packer_cls(runner, batch=8)
    healthy, doomed = p.open_video(), p.open_video()
    p.add(healthy, _stack(1, 0))
    p.add(doomed, _stack(2, 0))
    p.abort_video(doomed)
    done = []
    t = threading.Thread(target=lambda: done.append(p.close_video(healthy)))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "close_video wedged after a peer aborted"
    np.testing.assert_array_equal(done[0][:, 0], [1000.0])
    assert runner.groups == [1]


@pytest.mark.parametrize("batch,workers", [(4, 4), (8, 3)])
def test_concurrent_videos_exact_rows_in_both(batch, workers):
    """The same seeded clip counts (zero included) through both packers
    from ``workers`` threads: the same rows per video, in clip order, every
    clip dispatched once."""
    counts = [int(c) for c in
              np.random.default_rng(0).integers(0, 6, size=10)]
    results = {}
    for name, cls in PACKERS.items():
        runner = FakeRunner(delay=0.002)
        p = cls(runner, batch=batch, depth=2)

        def run_video(vid: int) -> np.ndarray:
            h = p.open_video()
            for i in range(counts[vid]):
                p.add(h, _stack(vid, i))
                time.sleep(0.001 * (vid % 3))
            return p.close_video(h)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            results[name] = list(pool.map(run_video, range(len(counts))))
        assert sum(runner.groups) == sum(counts)
    for vid, (got, want) in enumerate(zip(results["port"], results["jax"])):
        assert got.shape == want.shape
        if counts[vid]:
            np.testing.assert_array_equal(
                got[:, 0], [vid * 1000 + i for i in range(counts[vid])])
            np.testing.assert_array_equal(got, want)


def test_device_failure_poisons_only_group_members(packer_cls):
    p = packer_cls(PoisonRunner(fail_group=1), batch=2)
    h1, h2, h3 = p.open_video(), p.open_video(), p.open_video()
    p.add(h1, _stack(1, 0))
    p.add(h1, _stack(1, 1))   # group 0 (healthy)
    p.add(h2, _stack(2, 0))
    p.add(h3, _stack(3, 0))   # group 1 (poisoned)
    np.testing.assert_array_equal(p.close_video(h1)[:, 0], [1000.0, 1001.0])
    for doomed in (h2, h3):
        with pytest.raises(RuntimeError, match="failed on device"):
            p.close_video(doomed)


def test_dispatch_failure_propagates_and_poisons_peers(packer_cls):
    class Boom(FakeRunner):
        def dispatch(self, group):
            raise RuntimeError("compile blew up")

    p = packer_cls(Boom(), batch=2)
    h1, h2 = p.open_video(), p.open_video()
    p.add(h1, _stack(1, 0))
    with pytest.raises(RuntimeError, match="compile blew up"):
        p.add(h2, _stack(2, 0))
    p.abort_video(h2)
    with pytest.raises(RuntimeError, match="failed on device"):
        p.close_video(h1)


def test_stack_mismatch_poisons_members(packer_cls):
    p = packer_cls(FakeRunner(), batch=2)
    h1, h2 = p.open_video(), p.open_video()
    p.add(h1, _stack(1, 0))
    with pytest.raises(ValueError):
        p.add(h2, np.zeros((2, 3, 3, 3), np.float32))
    p.abort_video(h2)
    with pytest.raises(RuntimeError, match="failed on device"):
        p.close_video(h1)


def test_add_fails_fast_after_poison(packer_cls):
    p = packer_cls(PoisonRunner(fail_group=0), batch=2, depth=1)
    h1, h2 = p.open_video(), p.open_video()
    p.add(h1, _stack(1, 0))
    p.add(h2, _stack(2, 0))   # group 0, poisoned at its read
    p.add(h1, _stack(1, 1))
    p.add(h2, _stack(2, 1))   # group 1: in flight 2 > depth 1, drains 0
    with pytest.raises(RuntimeError, match="failed on device"):
        p.add(h1, _stack(1, 2))


def test_packer_over_cpu_replicas():
    """Over ``DataParallelApply.dispatch`` (a list of chunks, one per
    replica): every video's rows in clip order, all groups full but the
    last."""
    runner = DataParallelApply(
        lambda net, b: b.reshape(b.shape[0], -1).mean(dim=1, keepdim=True),
        torch.nn.Identity(), get_mesh("cpu", n_devices=2))
    sizes = []
    dispatch = runner.dispatch
    runner.dispatch = lambda g: sizes.append(len(g)) or dispatch(g)
    p = ClipPacker(runner, batch=4)
    handles = [p.open_video() for _ in range(3)]
    for i in range(3):
        for vid, h in enumerate(handles):
            p.add(h, _stack(vid, i))
    for vid, h in enumerate(handles):
        np.testing.assert_array_equal(p.close_video(h)[:, 0],
                                      [vid * 1000 + i for i in range(3)])
    assert sizes == [4, 4, 1]


def _write_clip(path: str, frames: int, seed: int) -> str:
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 16.0,
                        (64, 48))
    if not w.isOpened():
        pytest.skip("cv2 cannot encode mp4v")
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    for t in range(frames):
        frame = np.stack([
            127 + 120 * np.sin(xx / 9 + t / 5 + seed),
            127 + 120 * np.sin(yy / 7 - t / 6 + 2 * seed),
            127 + 120 * np.sin((xx + yy) / 11 + t / 4 + 3 * seed)], axis=-1)
        w.write(frame.clip(0, 255).astype(np.uint8))
    w.release()
    return path


def test_r21d_cli_cross_video_matches_unpacked_and_jax(tmp_path):
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain
    from video_features_tpu_torch.models import r21d as tr
    from video_features_tpu_torch.weights.bridge import seeded_init_

    ckpt = tmp_path / "r21d.pt"
    torch.save(seeded_init_(tr.R2Plus1D("r2plus1d_18_16_kinetics"), 11)
               .state_dict(), ckpt)
    vids = [_write_clip(str(tmp_path / f"v{i}.mp4"), frames, i)
            for i, frames in enumerate((16, 32, 32))]
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video at all")
    vids.insert(1, str(bad))

    def run(main, out, packed):
        keys = (["cross_video_batching=true", "video_workers=2",
                 "mesh_devices=2"] if packed else [])
        main(["feature_type=r21d", "device=cpu", f"weights_path={ckpt}",
              "on_extraction=save_numpy", f"output_path={tmp_path / out}",
              f"tmp_path={tmp_path / ('tmp_' + out)}", "clip_batch_size=2",
              "retry_attempts=1", "video_paths=[" + ",".join(vids) + "]",
              *keys])
        return {p.name: np.load(p)
                for p in sorted((tmp_path / out).rglob("*_r21d.npy"))}

    plain = run(tmain, "plain", packed=False)
    packed = run(tmain, "packed", packed=True)
    jax_packed = run(jmain, "jax", packed=True)
    names = ["v0_r21d.npy", "v1_r21d.npy", "v2_r21d.npy"]
    assert sorted(plain) == sorted(packed) == sorted(jax_packed) == names
    for name, clips in zip(names, (1, 2, 2)):
        assert packed[name].shape == (clips, 512)
        np.testing.assert_allclose(packed[name], plain[name], rtol=0,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(packed[name], jax_packed[name], rtol=0,
                                   atol=1e-2, err_msg=name)
