"""Per-stage timing and the device trace capture (port of
``video_features_tpu/utils/profiling.py``).

  - :data:`profiler`: a process-global stage timer. The pipelines wrap
    their phases in ``with profiler.stage(name)``; when nothing consumes
    the timings the context manager is a no-op (two attribute reads), so
    the instrumentation stays in place. The stages:

      ``decode``   cv2 read or grab, colour conversion and the host
                   transform (``utils/io.py``, ``parallel/fanout.py``);
      ``h2d``      enqueueing a host batch's copy to its device
                   (``parallel/mesh.py DataParallelApply.dispatch``): the
                   pinned staging copy and the non-blocking transfer's
                   launch, a lower bound on the wire time, as JAX's
                   ``device_put``; on the CPU the whole (zero-copy) move;
      ``forward``  the host's wait for a forward's result
                   (``DataParallelApply.__call__``, and under the async
                   path ``FeatureStream`` and ``parallel/packer.py``): its
                   *stall* on the card, not device time; near zero means
                   the card's work is hidden behind decode. The launch
                   itself is in no stage (``parallel/mesh.py``);
      ``write``    the sink's atomic file write (``utils/sinks.py``);
      ``health``   the output digests (``telemetry/health.py``).

    No stage adds a ``torch.cuda.synchronize`` or a blocking copy that the
    run does not already make.
  - ``profile=true`` on the CLI prints the aggregate breakdown at the end
    of the run (:meth:`StageProfiler.summary`): the decode, h2d, forward
    and write split that says whether the card or the host binds.
  - ``profile_trace_dir=/path`` also captures a ``torch.profiler`` trace of
    the run, CPU and CUDA activities (:class:`TraceCapture`), written as a
    Chrome trace that Perfetto reads, with the device's kernels by name.
  - ``telemetry=true`` and ``trace=true`` ride the same ``profiler.stage``
    call sites: their recorders install :meth:`StageProfiler.set_hook` and
    :meth:`StageProfiler.set_trace_hook`. Stages are timed whenever any of
    the three consumers is on.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Tuple


class StageProfiler:
    """Accumulates wall time and call counts per named stage."""

    def __init__(self) -> None:
        import threading
        self.enabled = False
        self._lock = threading.Lock()  # decode runs in the Prefetcher thread
        self._times: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._hook: Optional[Callable[[str, float], None]] = None
        self._trace_hook: Optional[Callable[[str, float, float],
                                            None]] = None

    def set_hook(self, hook: Optional[Callable[[str, float], None]]) -> None:
        """Install (or clear, with None) a per-observation callback
        ``hook(stage_name, seconds)`` — the telemetry recorder's feed.
        Timing happens whenever ``enabled`` OR a hook is present."""
        self._hook = hook

    def set_trace_hook(self, hook: Optional[Callable[[str, float, float],
                                                     None]]) -> None:
        """Install (or clear) ``hook(stage_name, t0_perf, seconds)`` —
        the trace recorder's feed (telemetry/trace.py). Unlike the
        aggregate hook it receives the START time too, so each stage
        call becomes one complete timeline event."""
        self._trace_hook = hook

    @contextmanager
    def stage(self, name: str) -> Iterator[None]:
        hook = self._hook
        trace_hook = self._trace_hook
        if not self.enabled and hook is None and trace_hook is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if self.enabled:
                with self._lock:
                    self._times[name] += dt
                    self._counts[name] += 1
            if hook is not None:
                try:
                    hook(name, dt)
                except Exception:
                    pass  # observability must never fail the pipeline
            if trace_hook is not None:
                try:
                    trace_hook(name, t0, dt)
                except Exception:
                    pass

    def add(self, name: str, dt: float, n: int = 1) -> None:
        """Accumulate an externally-timed observation (the telemetry
        recorder's delta/total accumulators use this; ``enabled`` gates
        only the context-manager path)."""
        with self._lock:
            self._times[name] += dt
            self._counts[name] += n

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            return {k: (self._times[k], self._counts[k])
                    for k in self._times}

    def reset(self) -> None:
        with self._lock:
            self._times.clear()
            self._counts.clear()

    def drain(self) -> Dict[str, Tuple[float, int]]:
        """Snapshot and reset under one lock acquisition: a
        ``snapshot()``-then-``reset()`` pair could lose an update landing
        between the two, so the heartbeat's per-interval delta
        (``telemetry/recorder.py``) drains."""
        with self._lock:
            out = {k: (self._times[k], self._counts[k])
                   for k in self._times}
            self._times.clear()
            self._counts.clear()
            return out

    def summary(self, title: str = "profile") -> str:
        """The aggregate per-stage breakdown. Stages overlap in wall time
        (decode runs on the Prefetcher thread while forward waits on the
        main thread), so the accounted total can exceed the wall clock:
        that overlap is the pipeline working as designed."""
        snap = self.snapshot()
        if not snap:
            return f"[{title}] no stages recorded"
        total = sum(t for t, _ in snap.values())
        lines = [f"[{title}] total accounted: {total:.3f}s"]
        for name, (t, n) in sorted(snap.items(), key=lambda kv: -kv[1][0]):
            lines.append(
                f"  {name:<10} {t:8.3f}s  {100 * t / total:5.1f}%  "
                f"{n:6d} calls  {1e3 * t / max(n, 1):8.3f} ms/call")
        return "\n".join(lines)


profiler = StageProfiler()


class TraceCapture:
    """A ``torch.profiler`` trace of a region, CPU and (with a card) CUDA
    activities, exported as a Chrome trace to
    ``{trace_dir}/{host}_{pid}.{ms}.pt.trace.json`` (:attr:`path`); a no-op
    when ``trace_dir`` is None. A capture that cannot start raises, and so
    does one that traced kernel launches on a card but no device activity
    (CUPTI did not start): the run fails rather than going on uncaptured.
    """

    #: the CUDA runtime and driver calls that launch a kernel
    _LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
                 "cudaLaunchKernelExC", "cuLaunchKernelEx")

    def __init__(self, trace_dir: Optional[str]) -> None:
        self.trace_dir = trace_dir
        self.path: Optional[str] = None
        self._prof = None
        self._cuda = False

    def __enter__(self) -> "TraceCapture":
        if self.trace_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self._cuda = torch.cuda.is_available()
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self._cuda else [])
            prof = profile(activities=activities)
            prof.__enter__()
            self._prof = prof
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        prof, self._prof = self._prof, None
        if prof is None:
            return False
        prof.__exit__(exc_type, exc, tb)
        import os
        import socket
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(
            self.trace_dir, f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1000)}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.path = path
        if self._cuda and exc_type is None:
            from torch.autograd import DeviceType
            # the raw records, not prof.events(): building the event tree
            # of a run's ~10^5 kernels takes longer than the run
            raw = getattr(prof.profiler, "kineto_results", None)
            events = raw.events() if raw is not None else prof.events()
            launched = on_device = False
            for e in events:
                name, device = _field(e, "name"), _field(e, "device_type")
                launched = launched or name in self._LAUNCHES
                on_device = on_device or device == DeviceType.CUDA
            if launched and not on_device:
                raise RuntimeError(
                    f"profile_trace_dir: torch.profiler traced kernel "
                    f"launches but no device activity (CUPTI did not "
                    f"start); the trace {path} has no device timeline")
        return False


def _field(event, name: str):
    """A profiler record's field: a method on the raw kineto record, an
    attribute on a ``FunctionEvent``."""
    value = getattr(event, name)
    return value() if callable(value) else value
