"""The profiler stages of the port's dispatch (``parallel/mesh.py``) against
the JAX package's, on replicas on the CPU.

- no ``h2d`` span overlaps a ``forward`` span, on the synchronous path
  (``DataParallelApply.__call__``), the streamed path (``FeatureStream``)
  and the packer, over one and two replicas: stages are flat, so one inside
  another would count in both;
- ``__call__`` gives exactly one ``h2d`` and one ``forward`` a call, as
  JAX's ``__call__`` gives one ``forward``;
- a forward that takes 50 ms on the host (the eager launch) lands in
  ``forward`` on both paths; a streamed batch has two ``forward`` spans,
  the launch and the wait.
"""
import time

import numpy as np
import pytest
import torch
from torch import nn

from video_features_tpu.parallel import mesh as jmesh
from video_features_tpu.utils.profiling import profiler as jprofiler
from video_features_tpu_torch.parallel.mesh import DataParallelApply, get_mesh
from video_features_tpu_torch.parallel.packer import ClipPacker
from video_features_tpu_torch.utils.profiling import profiler

SLEEP_S = 0.05


def _sleepy(net: nn.Module, batch: torch.Tensor) -> torch.Tensor:
    """A forward whose host side takes 50 ms, as an eager launch does."""
    time.sleep(SLEEP_S)
    return net(batch.float())


class _Recorder:
    """The spans of a :class:`StageProfiler`'s trace hook."""

    def __init__(self, prof) -> None:
        self.prof = prof
        self.spans = []

    def __enter__(self):
        self.prof.set_trace_hook(
            lambda name, t0, dt: self.spans.append((name, t0, t0 + dt)))
        return self

    def __exit__(self, *exc):
        self.prof.set_trace_hook(None)

    def of(self, name):
        return [(a, b) for n, a, b in self.spans if n == name]

    def total(self, name) -> float:
        return sum(b - a for a, b in self.of(name))

    def assert_flat(self) -> None:
        for a0, a1 in self.of("h2d"):
            for b0, b1 in self.of("forward"):
                assert a1 <= b0 or b1 <= a0, (
                    f"h2d [{a0}, {a1}] overlaps forward [{b0}, {b1}]")


def _runner(n_devices: int, fn=_sleepy) -> DataParallelApply:
    torch.manual_seed(0)
    return DataParallelApply(fn, nn.Linear(4, 3),
                             get_mesh("cpu", n_devices=n_devices))


@pytest.mark.parametrize("n_devices", [1, 2])
def test_call_gives_one_h2d_then_one_forward(n_devices):
    runner = _runner(n_devices)
    with _Recorder(profiler) as rec:
        for rows in (1, 3, 4):
            out = runner(np.ones((rows, 4), np.float32))
            assert out.shape == (rows, 3)
    assert [n for n, _, _ in rec.spans] == ["h2d", "forward"] * 3
    rec.assert_flat()
    # the launch of every replica's forward is in the one forward span
    for a, b in rec.of("forward")[1:]:
        assert b - a >= SLEEP_S * min(n_devices, 3)


def test_jax_call_gives_one_forward():
    runner = jmesh.DataParallelApply(lambda p, b: b * p["s"] + 1.0,
                                     {"s": np.float32(2.0)})
    with _Recorder(jprofiler) as rec:
        for rows in (1, 3):
            runner(np.ones((rows, 4), np.float32))
    assert [n for n, _, _ in rec.spans] == ["forward"] * 2


@pytest.mark.parametrize("n_devices", [1, 2])
@pytest.mark.parametrize("depth", [0, 2])
def test_stream_launch_and_wait_are_forward_spans(n_devices, depth):
    runner = _runner(n_devices)
    batches = [np.full((3, 4), i, np.float32) for i in range(4)]
    with _Recorder(profiler) as rec:
        stream = runner.stream(depth=depth)
        for b in batches:
            stream.submit(b)
        outs = stream.finish()
    assert len(outs) == 4
    rec.assert_flat()
    # two forward spans a batch: the launch (in dispatch) and the wait
    assert len(rec.of("forward")) == 2 * len(batches)
    assert len(rec.of("h2d")) == len(batches)
    assert rec.total("forward") >= SLEEP_S * len(batches)


def test_packer_dispatch_lands_in_forward():
    runner = _runner(2, fn=lambda net, b: (time.sleep(SLEEP_S),
                                           net(b.float()))[1])
    with _Recorder(profiler) as rec:
        packer = ClipPacker(runner, batch=4)
        h = packer.open_video()
        for i in range(8):
            packer.add(h, np.full((4,), i, np.float32))
        rows = packer.close_video(h)
    assert rows.shape == (8, 3)
    rec.assert_flat()
    assert rec.total("forward") >= SLEEP_S * 2
