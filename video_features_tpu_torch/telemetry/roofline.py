"""Roofline observatory: MFU accounting per family (port of
``video_features_tpu/telemetry/roofline.py``).

``roofline=true`` joins three things into a per-family effective TFLOPS,
an MFU and one of four verdicts (:func:`classify`), written to
``{output_path}/_roofline.json`` (``roofline.schema.json``, a copy of the
JAX package's) at the end of the run, with a live ``roofline`` section in
the heartbeats and ``_run.json`` (``telemetry/recorder.py``):

  - **cost cards** (:meth:`RooflineObserver.run_dispatch`, called from
    ``parallel/mesh.py DataParallelApply.dispatch`` for each replica's
    chunk): the first dispatch of each ``(runner, chunk shape, dtype)``
    runs under a counting pass (:class:`CostCounter`), every further one
    bumps a counter. JAX lowers the program once and reads XLA's
    ``cost_analysis()``; eager PyTorch has no program to lower, so the
    count is taken on that first real dispatch, which it slows on the host
    and never synchronizes. The count is XLA's cost analysis of the
    lowered (unfused) program, rule by rule, read off one-op programs
    lowered in JAX on the CPU (:class:`CostCounter`; composite ops are
    counted as the ops they run):

    - convolution: 2 x the multiply-adds whose input lies on the data.
      Taps on the padding are not counted (a 3x3x3 convolution padded 1
      on a 4^3 input: 2,000, where every tap would be 3,456), nor taps on
      the zeros of an ``F.pad`` just before a VALID convolution. A bias
      adds 1 an output.
    - dot (``mm``, ``bmm``): 2 M N K; ``addmm``'s bias 1 an output.
    - pointwise (``torch.Tag.pointwise``): 1 an output element; 0 for a
      transcendental (``exp``, ``log``, ``tanh``, ``sqrt``, ``rsqrt``,
      ``erf``, ...: XLA counts those apart); 3 for the logistic (a negate,
      an add and a divide around its exp); a clamp 1 a bound.
    - convert (``_to_copy``, ``copy_`` to another dtype): 1 an element;
      0 for a copy (``clone``, ``contiguous``).
    - reduce (``sum``, ``amax``, ...): n - 1 a result; ``mean`` 1 more.
    - variance (``var``, ``std``): 4 an element, 1 a result and 3, as
      ``jnp.var`` lowers (a mean, a subtract, a square, a second mean and
      its ddof's scalar ops; the ``sqrt`` of ``std`` counts 0).
    - max pool: window - 1 a result; average pool: window a result;
      padding or not.
    - softmax: 4 an element less 1 a row.
    - batch norm with the batch's statistics (RAFT's instance norm): 7 an
      element, as JAX's ``instance_norm`` lowers; with running
      statistics 2; layer norm 5 an element and 4 a row; an affine scale
      and shift 2 more an element.
    - pad, concatenate, layout, fill: 0.

    Plus the declared work of each RAFT correlation lookup
    (``kernels/corr_lookup.py kernel_work``): the CUDA kernels are reached
    through ``ctypes`` and no dispatcher pass sees them, and the lookups'
    plain versions report the same declared work with their own aten ops
    left out, so a card counted on the CPU equals one counted on the card.
    On the CPU at the shapes of ``tests/test_torch_roofline_parity.py`` the
    port's FLOPs are 1.000001x JAX's ``program_cost`` on I3D RGB (1, 10,
    224, 224, 3) and R(2+1)D-18 (1, 8, 32, 32, 3), 1.000000x on ResNet-18
    (2, 64, 64, 3), and a small RAFT's dense ops (2 iterations, (2, 64,
    96, 3) pairs) 0.9999997x JAX's gather RAFT's less its lookups. XLA's
    cost analysis counts a while loop's body once, whatever its trip
    count, so JAX's ``program_cost`` of its RAFT (an ``nn.scan`` over the
    iterations) counts one update iteration of 20; the port counts every
    iteration it runs.

    Bytes are the input and output bytes of every aten op the pass sees
    that moves data (views, bare allocations and an op that returns its own
    input move none): the traffic of eager PyTorch, where each op reads its
    inputs from device memory and writes its output back. XLA's ``bytes
    accessed`` is that of the unfused program, so the two differ by class
    (MB, port - JAX, I3D RGB at (1, 10, 224, 224, 3); port 0.8877x JAX's
    988.35 against 1,113.43; R(2+1)D-18 0.7793x, ResNet-18 0.8630x; held
    by ``tests/test_torch_roofline_parity.py BYTES_GAP_MB`` against each
    instruction of JAX's lowered program):

    - broadcast (JAX 304 ops, port none): -172.49. JAX's unfused program
      writes each batch norm's scale and shift and each ReLU's zero out at
      full size; eager PyTorch broadcasts inside the op.
    - multiply, add, ReLU / maximum (port 440 ops, JAX 342): -171.06. So
      each JAX elementwise op reads a full-size second operand where the
      port's reads a channel vector or a scalar.
    - zero-width pads (port 38, JAX none): +121.23. The port's ``F.pad``
      before each 1x1x1 convolution is a copy in eager PyTorch; JAX pads
      in the convolution.
    - zero pads (port 32, JAX 12): +43.09. The port pads each 3x3x3 and
      7x7x7 convolution's input apart; JAX pads only its pools.
    - max pools (port 13, JAX 14 reduce-windows): +43.87.
      ``max_pool3d`` writes int64 indices beside its values.
    - convolutions (57 each): +10.54. The port's read their padded input.
    - concatenate, subtract, rsqrt, reduce: equal.

    R(2+1)D-18 has only the first two causes (-31.21 and -30.83);
    ResNet-18 those (-4.87 and -4.73) and its max pool's indices (+0.26).
    Nothing the port counts is traffic that no op moves; the gap is JAX's
    unfused program (its broadcasts) on one side and eager PyTorch's pads
    and pool indices on the other, and both are left as they are.
  - **measured time**: on a card, one pair of CUDA events recorded on the
    replica's stream around each dispatch's launches; a pair's elapsed
    time is read once its end event has completed (``query()``), never
    waited for, so the accounting adds no synchronize: the run's own reads
    of its results (``to_host``) have fenced every pair by the end of the
    run. That device window is ``forward_s``. It is not JAX's ``forward``
    stage: under eager PyTorch the ``forward`` stages are the host's
    launch of a forward and its wait for the result, whose sum on the card
    is neither the device's time nor bounded below by it (the launch of a
    forward runs ahead of the device), so JAX's arithmetic would not bound
    the MFU. The window runs from the first launch to the last
    kernel's end, device idle gaps included, so it is never shorter than
    the device's busy time and an honest FLOP count gives ``mfu <= 1``. On
    the CPU the forward is synchronous: ``forward_s`` is the host time of
    the dispatch's calls plus what the ``forward`` stages hold beyond those
    calls (the wait and the copy back). ``h2d`` is
    the ``h2d`` stage, through the profiler's stage hook, as in JAX.
    The counting pass puts a Python dispatch mode on every aten op of its
    dispatch, which slows that dispatch's launches and so its window.
    Where a family has dispatches that ran without it, the counted ones
    are left out: ``forward_s`` and ``forward_calls`` are the uncounted
    windows, ``flops_total`` and ``bytes_total`` their work. A family whose
    every dispatch was counted (one video at one shape) is read over its
    counted windows, and its MFU then includes the counting pass.
    ``dispatches`` counts every dispatch.
  - **peak registry** (:data:`PEAK_REGISTRY`, :func:`peak_for_device`):
    the MFU's denominator is a measured practical bf16 peak where one is
    known (the H100's from :func:`measure_peak` on the card), else the
    cached or fresh microbench. MFU is against the bf16 tensor-core peak
    whatever the run's dtype, as in JAX: a float32 run with TF32 off reads
    a small MFU by construction.

The four verdicts, the thresholds, the field tuples and the report
(:func:`report_main`, ``python -m video_features_tpu_torch.telemetry.
roofline DIR [--profile TRACE_DIR]``, whose ``--profile`` reads the
``torch.profiler`` Chrome trace of ``profile_trace_dir``) are the JAX
module's.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import re
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from .jsonl import write_json_atomic
from .spans import current_span

SCHEMA_VERSION = "vft.roofline/1"
ROOFLINE_FILENAME = "_roofline.json"

#: the four roofline positions; the schema's enum is this exact set
VERDICTS = ("compute-bound", "bandwidth-bound", "launch-overhead-bound",
            "host-bound")

#: classification thresholds (:func:`classify`): device share below which
#: the device is held back by the host, and the explained-time floor below
#: which fixed launch overhead is the only remaining account
HOST_BOUND_SHARE = 0.35
LAUNCH_FRAC = 0.15

#: emitter field lists, equal to the schema's properties
ROOFLINE_FIELDS = ("schema", "run_id", "host_id", "feature_type", "time",
                   "wall_s", "device", "families")
DEVICE_FIELDS = ("platform", "device_kind", "peak_tflops", "nominal_tflops",
                 "peak_gbps", "source")
FAMILY_FIELDS = ("programs", "flops_total", "bytes_total", "dispatches",
                 "forward_s", "forward_calls", "h2d_s", "wall_s",
                 "device_share", "arithmetic_intensity", "effective_tflops",
                 "effective_tflops_wall", "mfu", "verdict")
CARD_FIELDS = ("shape", "dtype", "batch", "flops", "bytes", "intensity",
               "dispatches")

#: per-device-kind peaks. ``peak_tflops`` is the denominator of every MFU:
#: the measured practical bf16 ceiling where there is one, the public
#: nominal dense bf16 rate otherwise; ``nominal_tflops`` the public
#: nominal; ``peak_gbps`` the public HBM rate. Matched by normalized
#: substring. The H100 SXM names itself ``NVIDIA H100 80GB HBM3``; the
#: PCIe and NVL parts, whose peaks differ, match no entry. Its
#: ``peak_tflops`` is :func:`measure_peak` as ``chip_smoke.py`` printed it
#: on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (773.7 TFLOPS, the
#: read rate 3,065 GB/s; the script prints a fresh measurement beside this
#: entry on every run); the nominal is NVIDIA's data sheet's 989.4 TFLOPS
#: dense bf16 at 700 W, the HBM rate its 3,350 GB/s.
PEAK_REGISTRY: Dict[str, Dict[str, float]] = {
    "tpu v5 lite": {"peak_tflops": 127.0, "nominal_tflops": 197.0,
                    "peak_gbps": 819.0},
    "tpu v5e": {"peak_tflops": 127.0, "nominal_tflops": 197.0,
                "peak_gbps": 819.0},
    "tpu v5p": {"peak_tflops": 459.0, "nominal_tflops": 459.0,
                "peak_gbps": 2765.0},
    "tpu v4": {"peak_tflops": 275.0, "nominal_tflops": 275.0,
               "peak_gbps": 1228.0},
    "tpu v3": {"peak_tflops": 123.0, "nominal_tflops": 123.0,
               "peak_gbps": 900.0},
    "tpu v6": {"peak_tflops": 918.0, "nominal_tflops": 918.0,
               "peak_gbps": 1640.0},
    "nvidia h100 80gb hbm3": {"peak_tflops": 773.7,
                              "nominal_tflops": 989.4,
                              "peak_gbps": 3350.0},
}


def roofline_filename(host_id: Optional[str] = None) -> str:
    """``_roofline.json``, or the per-host ``_roofline_{host_id}.json``
    when several workers share one output dir."""
    if host_id is None:
        return ROOFLINE_FILENAME
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(host_id))
    return f"_roofline_{safe}.json"


# -- the count ---------------------------------------------------------------

_tls = threading.local()


def _nbytes(value: Any) -> int:
    """Bytes of the tensors in ``value`` (a tensor, or a list, tuple or
    dict of them)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (list, tuple)):
        return sum(_nbytes(v) for v in value)
    if isinstance(value, dict):
        return sum(_nbytes(v) for v in value.values())
    return 0


#: the aten ops that allocate without writing, or read one scalar
_NO_TRAFFIC = frozenset((
    torch.ops.aten.empty, torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided, torch.ops.aten._local_scalar_dense))

_aten = torch.ops.aten
#: pointwise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = frozenset(
    getattr(_aten, name) for name in (
        "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
        "rsqrt", "tanh", "sin", "cos", "tan", "asin", "acos", "atan",
        "atan2", "sinh", "cosh", "asinh", "acosh", "atanh", "erf", "erfc",
        "erfinv", "lgamma", "digamma") if hasattr(_aten, name))
_CONVOLUTIONS = frozenset((_aten.convolution, _aten._convolution))
_MAX_POOLS = frozenset((_aten.max_pool1d, _aten.max_pool2d,
                        _aten.max_pool3d, _aten.max_pool2d_with_indices,
                        _aten.max_pool3d_with_indices))
_AVG_POOLS = frozenset((_aten.avg_pool1d, _aten.avg_pool2d, _aten.avg_pool3d))
_ADAPTIVE_AVG_POOLS = frozenset((
    _aten._adaptive_avg_pool2d, _aten._adaptive_avg_pool3d,
    _aten.adaptive_avg_pool1d))
#: reductions: XLA's reduce adds n - 1 FLOPs a result; mean divides once
_REDUCTIONS = frozenset((_aten.sum, _aten.amax, _aten.amin, _aten.max,
                         _aten.min, _aten.prod))
#: variances: ``jnp.var`` lowers to a mean, a subtract, a square and a
#: second mean (4 an element, 1 a result) and 3 scalar ops for its ddof
_VARIANCES = frozenset((_aten.var, _aten.std, _aten.var_mean,
                        _aten.std_mean))
_SOFTMAXES = frozenset((_aten._softmax, _aten._log_softmax))
#: the batch norms as CPU and card run them (one count for both)
_BATCH_NORMS = frozenset(getattr(_aten, name) for name in (
    "native_batch_norm", "_native_batch_norm_legit",
    "_native_batch_norm_legit_no_training", "cudnn_batch_norm",
    "miopen_batch_norm") if hasattr(_aten, name))
#: copies, which XLA counts as a convert (1 FLOP an element) only where
#: the dtype changes (``clone`` is tagged pointwise but moves data only)
_COPIES = frozenset((_aten._to_copy, _aten.copy_, _aten.copy, _aten.clone))
#: the matrix products of ``torch.utils.flop_counter``'s registry (2 M N K,
#: XLA's dot); a bias add counts one more an element
_BIASED = frozenset((_aten.addmm, _aten.baddbmm, _aten.addmv))


def _tensors(value: Any) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _numel(value: Any) -> int:
    """Elements of ``value``'s first tensor (an op's result)."""
    ts = _tensors(value)
    return ts[0].numel() if ts else 0


def _valid_taps(size: int, lo: int, hi: int, pad: int, kernel: int,
                stride: int, dilation: int, out: int) -> int:
    """(output, tap) pairs of one spatial dim whose input lies on the data:
    ``size`` is the convolution's input, of which ``lo`` and ``hi`` are
    zeros that a pad op added just before it, ``pad`` the convolution's own
    low padding."""
    data = size - lo - hi
    return sum(1 for o in range(out) for j in range(kernel)
               if 0 <= o * stride - pad + j * dilation - lo < data)


class CostCounter:
    """FLOPs and bytes of the work run on this thread inside it, counted as
    XLA's cost analysis counts the lowered program (module docstring), plus
    the declared work that the correlation lookups report (:meth:`declare`),
    with the aten ops of a declared body left out. One dispatch mode sees
    every op after the decompositions of the composite ops; it reads
    shapes only: no synchronize, no copy."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self._paused = 0
        self._mode = None
        #: per aten op: [calls, flops, bytes]
        self.by_op: Dict[str, List[int]] = {}
        #: id of a pad op's result -> (a weak reference to it, its pads)
        self._padded: Dict[int, Tuple[Any, Tuple[int, ...]]] = {}

    def __enter__(self) -> "CostCounter":
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _CostMode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                packet = func._overloadpacket
                if not counter._paused:
                    # a composite op is counted as the ops it runs
                    with self:
                        out = func.decompose(*args, **kwargs)
                    if out is not NotImplemented:
                        return out
                out = func(*args, **kwargs)
                if not counter._paused:
                    counter._count(func, packet, args, kwargs, out)
                return out

        self._mode = _CostMode()
        self._mode.__enter__()
        self._prev = getattr(_tls, "counter", None)
        _tls.counter = self
        return self

    def __exit__(self, *exc) -> bool:
        _tls.counter = self._prev
        self._mode.__exit__(*exc)
        self._padded.clear()
        return False

    def _count(self, func, packet, args, kwargs, out) -> None:
        inputs = _tensors(args) + _tensors(list(kwargs.values()))
        aliased = not func._schema.is_mutable and any(
            o is t for o in _tensors(out) for t in inputs)
        nbytes = flops = 0
        if not func.is_view and packet not in _NO_TRAFFIC and not aliased:
            nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        name = str(packet)
        if packet is _aten.constant_pad_nd:
            if not any(args[1]):
                name += " (zero width)"  # a clone in eager PyTorch
            self._note_pad(args, kwargs, out)
        else:
            flops = self._flops(func, packet, args, kwargs, out)
        self.bytes += nbytes
        self.flops += flops
        tally = self.by_op.setdefault(name, [0, 0, 0])
        tally[0] += 1
        tally[1] += flops
        tally[2] += nbytes

    def _note_pad(self, args, kwargs, out) -> None:
        """Remember a zero pad's result, whose added zeros a convolution
        that reads it counts as padding (``F.pad`` runs as this op)."""
        pad = tuple(int(p) for p in args[1])
        value = args[2] if len(args) > 2 else kwargs.get("value", 0)
        if not value and min(pad, default=0) >= 0:
            self._padded[id(out)] = (weakref.ref(out), pad)

    def _flops(self, func, packet, args, kwargs, out) -> int:
        from torch.utils.flop_counter import flop_registry
        n = _numel(out)
        if packet in _CONVOLUTIONS and not args[6]:
            return self._conv_flops(args, out)
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            return int(flops) + (n if packet in _BIASED else 0)
        if packet in _COPIES:
            src = args[1] if packet is _aten.copy_ else args[0]
            dst = _tensors(out)
            return n if dst and dst[0].dtype != src.dtype else 0
        if torch.Tag.pointwise in func.tags:
            if packet in _TRANSCENDENTAL:
                return 0
            if packet in (_aten.clamp, _aten.clip):  # a max, a min or both
                bounds = list(args[1:3]) + [kwargs.get("min"),
                                            kwargs.get("max")]
                return n * sum(b is not None for b in bounds)
            # the logistic: a negate, an add and a divide around its exp
            return 3 * n if packet is _aten.sigmoid else n
        if packet in _REDUCTIONS or packet is _aten.mean:
            total = args[0].numel() - n
            return total + (n if packet is _aten.mean else 0)
        if packet in _VARIANCES:
            return 4 * args[0].numel() + n + 3
        if packet in _MAX_POOLS or packet in _AVG_POOLS:
            kernel = [int(k) for k in args[1]]
            if len(kernel) == 1:  # one size for every spatial dim
                kernel *= args[0].dim() - 2
            window = math.prod(kernel)
            return (window - (1 if packet in _MAX_POOLS else 0)) * n
        if packet in _ADAPTIVE_AVG_POOLS:
            return args[0].numel()
        if packet in _BATCH_NORMS:
            # with the batch's statistics (an instance norm): 7 an element,
            # as JAX's instance_norm lowers; with running statistics, a
            # scale and a shift; an affine weight and bias 2 more
            stats = packet is not _aten._native_batch_norm_legit_no_training
            training = stats and next(
                (a for a in args[3:] if isinstance(a, bool)), False)
            affine = 2 if args[1] is not None else 0
            return ((7 if training else 2) + affine) * n
        if packet is _aten.native_layer_norm:
            rows = n // max(1, math.prod(args[1]))
            return 5 * n + 4 * rows + (2 * n if args[2] is not None else 0)
        if packet in _SOFTMAXES:
            rows = n // max(1, args[0].shape[args[1]])
            return 4 * n - rows
        return 0

    def _conv_flops(self, args, out) -> int:
        """2 x the multiply-adds whose input lies on the data, as XLA
        counts a convolution: taps on the convolution's own padding, or on
        the zeros of a pad op just before it, are left out; a bias adds
        one FLOP an output element."""
        x, w, bias, stride, padding, dilation = args[:6]
        y = _tensors(out)[0]
        spatial = x.dim() - 2
        lo_hi = [(0, 0)] * spatial
        ref, pads = self._padded.get(id(x), (None, ()))
        if ref is not None and ref() is x:
            dims = len(pads) // 2
            if dims <= spatial:
                for i in range(dims):
                    lo_hi[spatial - 1 - i] = (pads[2 * i], pads[2 * i + 1])

        def at(seq, i):
            return int(seq[i] if len(seq) > 1 else seq[0])

        taps = 1
        for i in range(spatial):
            taps *= _valid_taps(x.shape[2 + i], *lo_hi[i], at(padding, i),
                                w.shape[2 + i], at(stride, i),
                                at(dilation, i), y.shape[2 + i])
        flops = 2 * x.shape[0] * w.shape[0] * w.shape[1] * taps
        return flops + (y.numel() if bias is not None else 0)

    @contextlib.contextmanager
    def declare(self, name: str, nbytes: int, operations: int
                ) -> Iterator[None]:
        """Add ``name``'s declared work; the aten ops inside the block are
        not counted (a plain lookup's gathers and product)."""
        self.flops += int(operations)
        self.bytes += int(nbytes)
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1


def _declare(name: str, nbytes: int, operations: int):
    """``kernels/corr_lookup.py``'s ``work_hook`` while an observer is
    active: the declared work goes to the counter of this thread's counted
    dispatch, if any."""
    counter = getattr(_tls, "counter", None)
    if counter is None:
        return contextlib.nullcontext()
    return counter.declare(name, nbytes, operations)


def program_cost(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops": F, "bytes": B}`` of ``fn(*args)``, run once under a
    :class:`CostCounter` with the lookups' declared work included (the
    counterpart of JAX's ``lowered.cost_analysis()``; bench rows take their
    ``mfu`` from it)."""
    from ..kernels import corr_lookup
    prev, corr_lookup.work_hook = corr_lookup.work_hook, _declare
    try:
        with CostCounter() as c:
            fn(*args)
    finally:
        corr_lookup.work_hook = prev
    return {"flops": float(c.flops), "bytes": float(c.bytes)}


# -- peak resolution ----------------------------------------------------------

def _peak_cache_root() -> str:
    return os.environ.get(
        "VFT_ROOFLINE_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "video_features_tpu", "roofline"))


def _peak_cache_path(device_kind: str, cache_dir: Optional[str]) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(device_kind)) or "unknown"
    return os.path.join(cache_dir or _peak_cache_root(),
                        f"peak_{safe}.json")


def measure_peak(n: int = 8192, band_elems: int = 1 << 28,
                 calls: int = 8, trials: int = 3,
                 device: str = "cuda") -> Dict[str, float]:
    """The card's practical roofline corners:

      - **peak_tflops**: ``calls`` chained ``n``^3 bf16 matmuls (8192^3:
        about 1.1 TFLOP each, milliseconds on an H100, where JAX's 2048^3
        was sized for a v5e and would leave the card's 132 SMs part idle),
        fenced by one float read back from the last product;
      - **peak_gbps**: ``calls`` sums over ``band_elems`` float32 (1 GiB,
        twenty times the 50 MB L2), one read pass each, fenced the same
        way: the achievable read rate.

    Best of ``trials``. Raises without a card: a measurement that finds no
    card fails rather than measuring the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_peak needs a CUDA device")
    dev = torch.device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)
    b = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)
    c = torch.empty((n, n), dtype=torch.bfloat16, device=dev)
    torch.mm(a, b, out=c)
    float(c[0, 0])  # warm, and the fence's first use
    best_tf = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(calls):
            torch.mm(a, b, out=c)
        float(c[0, 0])  # D2H fence: the last product has finished
        dt = time.perf_counter() - t0
        best_tf = max(best_tf, calls * 2.0 * n ** 3 / dt / 1e12)
    del a, b, c
    x = torch.ones(band_elems, dtype=torch.float32, device=dev)
    float(x.sum())
    best_gb = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        out = None
        for _ in range(calls):
            out = x.sum()
        float(out)
        dt = time.perf_counter() - t0
        best_gb = max(best_gb, calls * band_elems * 4.0 / dt / 1e9)
    return {"peak_tflops": round(best_tf, 3), "peak_gbps": round(best_gb, 2),
            "matmul_n": n, "band_bytes": band_elems * 4}


def registry_peak(device_kind: str) -> Optional[Dict[str, float]]:
    """Registry entry for a device kind (normalized substring match), or
    None for unknown hardware."""
    norm = " ".join(str(device_kind).lower().split())
    for key, entry in PEAK_REGISTRY.items():
        if key in norm or norm in key:
            return dict(entry)
    return None


def _local_device() -> Tuple[str, str]:
    """(device kind, platform) of this process: the first card's name and
    ``gpu``, or ``cpu`` and ``cpu``."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0), "gpu"
    return "cpu", "cpu"


def peak_for_device(device_kind: Optional[str] = None,
                    platform: Optional[str] = None,
                    cache_dir: Optional[str] = None,
                    measure: bool = True,
                    measure_fn=measure_peak) -> Optional[Dict[str, Any]]:
    """The MFU denominator for this process's device, in precedence order:

      1. ``VFT_ROOFLINE_PEAK="tflops,gbps"`` env override;
      2. :data:`PEAK_REGISTRY` by device kind;
      3. a cached prior :func:`measure_peak` result for this kind;
      4. the microbench itself (cached for next time), skipped when
         ``measure=False`` (returns None).

    Returns the schema's ``device`` block."""
    env = os.environ.get("VFT_ROOFLINE_PEAK")
    if env:
        try:
            tf, gb = (float(v) for v in env.split(",")[:2])
        except ValueError:
            raise ValueError(
                f"VFT_ROOFLINE_PEAK={env!r}: expected 'tflops,gbps' "
                "(e.g. '127,819')") from None
    if device_kind is None or platform is None:
        kind, plat = _local_device()
        device_kind = kind if device_kind is None else device_kind
        platform = plat if platform is None else platform
    if env:
        return {"platform": platform, "device_kind": device_kind,
                "peak_tflops": tf, "nominal_tflops": tf, "peak_gbps": gb,
                "source": "env"}
    base = {"platform": platform, "device_kind": device_kind}
    reg = registry_peak(device_kind)
    if reg is not None:
        return {**base, **reg, "source": "registry"}
    cache_path = _peak_cache_path(device_kind, cache_dir)
    try:
        with open(cache_path, encoding="utf-8") as f:
            cached = json.load(f)
        if isinstance(cached, dict) and cached.get("peak_tflops"):
            return {**base, "peak_tflops": float(cached["peak_tflops"]),
                    "nominal_tflops": None,
                    "peak_gbps": float(cached.get("peak_gbps") or 0) or None,
                    "source": "microbench (cached)"}
    except (OSError, ValueError):
        pass
    if not measure:
        return None
    m = measure_fn()
    try:
        write_json_atomic(cache_path, {**m, "device_kind": device_kind,
                                       "time": round(time.time(), 3)})
    except OSError:
        pass  # unwritable cache root: measure again next process
    return {**base, "peak_tflops": m["peak_tflops"], "nominal_tflops": None,
            "peak_gbps": m["peak_gbps"], "source": "microbench"}


# -- the verdict --------------------------------------------------------------

def classify(flops: float, bytes_accessed: float, forward_s: float,
             wall_s: float, peak_tflops: Optional[float],
             peak_gbps: Optional[float]) -> Optional[str]:
    """One of the four :data:`VERDICTS` for a family's run, or None when
    the inputs cannot support a verdict (no work, no peak).

    The minimum device time for the work is ``max(flops / peak_flops,
    bytes / peak_bw)``; whichever term explains the observed device window
    is the bound, and a window neither term explains (both fractions under
    :data:`LAUNCH_FRAC`) is fixed per-dispatch overhead. Before that, a
    device window under :data:`HOST_BOUND_SHARE` of the wall clock means
    the device waited on the host."""
    if not flops or forward_s is None or forward_s <= 0 or not wall_s:
        return None
    if forward_s / wall_s < HOST_BOUND_SHARE:
        return "host-bound"
    if not peak_tflops:
        return None
    compute_frac = flops / (peak_tflops * 1e12) / forward_s
    bw_frac = (bytes_accessed / (peak_gbps * 1e9) / forward_s
               if peak_gbps else 0.0)
    if max(compute_frac, bw_frac) < LAUNCH_FRAC:
        return "launch-overhead-bound"
    return "compute-bound" if compute_frac >= bw_frac else "bandwidth-bound"


# -- the observer -------------------------------------------------------------

_lock = threading.Lock()
_active: Optional["RooflineObserver"] = None


def active() -> Optional["RooflineObserver"]:
    return _active


def snapshot() -> dict:
    """The heartbeat section: the active observer's light per-family
    summary, ``{}`` when roofline is off."""
    obs = _active
    if obs is None:
        return {}
    try:
        return obs.light_summary()
    except Exception:
        return {}


def ensure_for_extractor(ext) -> None:
    """Library-caller hook (``extractors/base.py _extract``): a process that
    never went through ``cli.py`` still gets an observer homed on the
    extractor's output dir when ``roofline=true``, closed (and its
    ``_roofline.json`` written) at interpreter exit. First observer wins."""
    if _active is not None:
        return
    args = getattr(ext, "args", None)
    if args is None or not bool(args.get("roofline", False)):
        return
    obs = RooflineObserver(str(ext.output_path),
                           default_family=str(ext.feature_type))
    if obs.start() is obs:
        atexit.register(obs.close)


class RooflineObserver:
    """Run-scoped MFU accounting: cost cards per dispatched program, device
    windows and the ``h2d`` stage per family -> effective TFLOPS, MFU and a
    verdict, written to ``_roofline.json`` at :meth:`close`.

    Process-global (one device, one accounting): :meth:`start` publishes it
    (first wins), chains onto the profiler's stage hook without displacing
    the telemetry recorder's, and installs the lookups' work hook. The peak
    resolves on a daemon thread."""

    def __init__(self, output_path: str, *,
                 default_family: Optional[str] = None,
                 run_id: Optional[str] = None,
                 host_id: Optional[str] = None) -> None:
        self.output_path = str(output_path)
        self.default_family = default_family
        self.run_id = run_id
        self.host_id = host_id
        self.path = os.path.join(self.output_path,
                                 roofline_filename(host_id))
        self._state = threading.Lock()
        #: (id(runner), shape, dtype) -> card (flops None: count failed)
        self._cards: Dict[Tuple, Dict[str, Any]] = {}
        #: family -> {"forward_s", "forward_calls" (the uncounted
        #: dispatches' windows), "count_s", "count_calls" (the counted
        #: ones'), "h2d_s", "wait_s" (the ``forward`` stages), "launch_s"
        #: (the host time of every dispatch's calls, on the CPU), "cpu"}
        self._stages: Dict[str, Dict[str, Any]] = {}
        #: (family, start, end, counted) event pairs not yet completed
        self._pending: deque = deque()
        self._peak: Optional[Dict[str, Any]] = None
        self._peak_thread: Optional[threading.Thread] = None
        self._prev_hook = None
        self._hook_fn = None
        self._prev_work_hook = None
        self._t0 = time.perf_counter()
        self._closed = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RooflineObserver":
        global _active
        with _lock:
            if _active is not None:
                return _active
            _active = self
        from ..kernels import corr_lookup
        from ..utils.profiling import profiler
        self._prev_hook = prev = profiler._hook

        def hook(name: str, dt: float) -> None:
            if prev is not None:
                prev(name, dt)
            self._observe_stage(name, dt)

        self._hook_fn = hook
        profiler.set_hook(hook)
        self._prev_work_hook = corr_lookup.work_hook
        corr_lookup.work_hook = _declare
        self._t0 = time.perf_counter()
        self._peak_thread = threading.Thread(
            target=self._resolve_peak, name="vft-roofline-peak",
            daemon=True)
        self._peak_thread.start()
        return self

    def close(self, write: bool = True) -> Optional[dict]:
        """Write ``_roofline.json`` atomically, restore the stage hook (only
        if still ours) and the lookups' work hook, drop the process-global
        slot. Returns the summary; never raises into a caller's finally."""
        global _active
        if self._closed:
            return None
        self._closed = True
        from ..kernels import corr_lookup
        from ..utils.profiling import profiler
        if profiler._hook is self._hook_fn:
            profiler.set_hook(self._prev_hook)
        if corr_lookup.work_hook is _declare:
            corr_lookup.work_hook = self._prev_work_hook
        with _lock:
            if _active is self:
                _active = None
        try:
            doc = self.summary(resolve_peak=True)
            if write:
                write_json_atomic(self.path, doc)
            return doc
        except Exception as e:
            print(f"roofline: close failed ({type(e).__name__}: {e}) — "
                  "accounting for this run is lost, extraction is not")
            return None

    # -- peak ---------------------------------------------------------------
    def _resolve_peak(self) -> None:
        try:
            peak = peak_for_device()
        except Exception:
            peak = None
        with self._state:
            self._peak = peak

    def peak(self, resolve: bool = False) -> Optional[Dict[str, Any]]:
        with self._state:
            peak = self._peak
        if peak is None and resolve:
            t = self._peak_thread
            if t is not None and t.is_alive():
                t.join(timeout=120.0)
            with self._state:
                peak = self._peak
        return peak

    # -- observation --------------------------------------------------------
    def _family(self) -> str:
        span = current_span()
        if span is not None and getattr(span, "feature_type", None):
            return str(span.feature_type)
        return str(self.default_family or "?")

    def _stage(self, fam: str) -> Dict[str, Any]:
        return self._stages.setdefault(
            fam, {"forward_s": 0.0, "forward_calls": 0, "count_s": 0.0,
                  "count_calls": 0, "h2d_s": 0.0, "wait_s": 0.0,
                  "launch_s": 0.0, "cpu": False})

    def run_dispatch(self, runner, replica, chunk):
        """``runner.apply_fn(replica, chunk)`` with its accounting: counted
        on the first dispatch of its key, its device window recorded. The
        forward's own errors propagate unchanged."""
        fam = self._family()
        key = (id(runner), tuple(chunk.shape), chunk.dtype)
        with self._state:
            card = self._cards.get(key)
            new = card is None
            if new:
                # placeholder first: a concurrent sibling dispatching the
                # same shape counts instead of counting twice
                card = {"family": fam,
                        "shape": [int(d) for d in chunk.shape],
                        "dtype": str(chunk.dtype).replace("torch.", ""),
                        "batch": int(chunk.shape[0]) if chunk.dim() else 1,
                        "flops": None, "bytes": None, "intensity": None,
                        "dispatches": 1}
                self._cards[key] = card
            else:
                card["dispatches"] += 1
        on_card = chunk.device.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        if new:
            with CostCounter() as cost:
                out = runner.apply_fn(replica, chunk)
            with self._state:
                card["flops"] = float(cost.flops)
                card["bytes"] = float(cost.bytes)
                card["intensity"] = (round(cost.flops / cost.bytes, 3)
                                     if cost.bytes else None)
        else:
            out = runner.apply_fn(replica, chunk)
        if on_card:
            end.record()
            with self._state:
                self._pending.append((fam, start, end, new))
            self._drain()
        else:
            dt = time.perf_counter() - t0
            with self._state:
                self._add_window(fam, dt, new)
                st = self._stage(fam)
                st["cpu"] = True
                st["launch_s"] += dt
        return out

    def _add_window(self, fam: str, dt: float, counted: bool) -> None:
        st = self._stage(fam)
        pre = "count" if counted else "forward"
        st[f"{pre}_s"] += dt
        st[f"{pre}_calls"] += 1

    def _drain(self) -> None:
        """Fold every completed event pair, oldest first, into its family's
        ``forward_s``; stops at the first pair still running (a query, never
        a wait)."""
        with self._state:
            while self._pending and self._pending[0][2].query():
                fam, start, end, counted = self._pending.popleft()
                self._add_window(fam, start.elapsed_time(end) / 1e3,
                                 counted)

    def _observe_stage(self, name: str, dt: float) -> None:
        if name not in ("forward", "h2d"):
            return
        fam = self._family()
        with self._state:
            st = self._stage(fam)
            st["h2d_s" if name == "h2d" else "wait_s"] += dt

    # -- summaries ----------------------------------------------------------
    def _family_doc(self, cards: List[dict], st: Dict[str, Any],
                    wall_s: float, peak: Optional[dict]) -> dict:
        # the work and windows of the uncounted dispatches, where there are
        # any; else of the counted ones, counting pass included
        clean = int(st.get("forward_calls", 0)) > 0
        def timed(c: dict) -> int:
            return c["dispatches"] - 1 if clean else 1

        flops_total = sum(c["flops"] * timed(c) for c in cards
                          if c.get("flops"))
        bytes_total = sum(c["bytes"] * timed(c) for c in cards
                          if c.get("bytes"))
        dispatches = sum(c["dispatches"] for c in cards)
        pre = "forward" if clean else "count"
        fwd = float(st.get(f"{pre}_s", 0.0))
        if st.get("cpu"):
            # the forward stages hold the calls timed above too
            fwd += max(float(st.get("wait_s", 0.0))
                       - float(st.get("launch_s", 0.0)), 0.0)
        eff = (flops_total / 1e12 / fwd if fwd > 0 and flops_total
               else None)
        eff_wall = (flops_total / 1e12 / wall_s
                    if wall_s > 0 and flops_total else None)
        peak_tf = (peak or {}).get("peak_tflops")
        peak_gb = (peak or {}).get("peak_gbps")
        programs = [{k: c.get(k) for k in CARD_FIELDS}
                    for c in sorted(cards, key=lambda c: -(c["flops"] or 0))]
        return {
            "programs": programs,
            "flops_total": flops_total,
            "bytes_total": bytes_total,
            "dispatches": dispatches,
            "forward_s": round(fwd, 6),
            "forward_calls": int(st.get(f"{pre}_calls", 0)),
            "h2d_s": round(float(st.get("h2d_s", 0.0)), 6),
            "wall_s": round(wall_s, 3),
            "device_share": (round(fwd / wall_s, 4) if wall_s > 0
                             else None),
            "arithmetic_intensity": (round(flops_total / bytes_total, 3)
                                     if bytes_total else None),
            "effective_tflops": (round(eff, 4) if eff is not None
                                 else None),
            "effective_tflops_wall": (round(eff_wall, 4)
                                      if eff_wall is not None else None),
            "mfu": (round(eff / peak_tf, 4)
                    if eff is not None and peak_tf else None),
            "verdict": classify(flops_total, bytes_total, fwd, wall_s,
                                peak_tf, peak_gb),
        }

    def summary(self, resolve_peak: bool = False) -> dict:
        """The full ``_roofline.json`` document (schema-shaped)."""
        self._drain()
        wall = time.perf_counter() - self._t0
        peak = self.peak(resolve=resolve_peak)
        with self._state:
            cards = [dict(c) for c in self._cards.values()]
            stages = {f: dict(s) for f, s in self._stages.items()}
        by_family: Dict[str, List[dict]] = {}
        for c in cards:
            by_family.setdefault(c.get("family") or "?", []).append(c)
        families = {}
        for fam in sorted(set(by_family) | set(stages)):
            families[fam] = self._family_doc(
                by_family.get(fam, []), stages.get(fam, {}), wall, peak)
        device = {k: (peak or {}).get(k) for k in DEVICE_FIELDS}
        if peak is None:
            # the kind is knowable before the resolver thread lands
            device["device_kind"], device["platform"] = _local_device()
            device["source"] = "unresolved"
        return {
            "schema": SCHEMA_VERSION,
            "run_id": self.run_id,
            "host_id": self.host_id,
            "feature_type": self.default_family,
            "time": round(time.time(), 3),
            "wall_s": round(wall, 3),
            "device": device,
            "families": families,
        }

    def light_summary(self) -> dict:
        """The heartbeat-sized view: per-family MFU and verdict without the
        cards, and without waiting on the peak."""
        doc = self.summary(resolve_peak=False)
        fams = {}
        for fam, f in doc["families"].items():
            fams[fam] = {k: f[k] for k in
                         ("dispatches", "effective_tflops", "mfu",
                          "device_share", "verdict")}
            fams[fam]["gflops_total"] = round(f["flops_total"] / 1e9, 1)
        return {"device": doc["device"], "families": fams}


# -- schema -------------------------------------------------------------------

ROOFLINE_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                                    "roofline.schema.json")


def load_roofline_schema() -> dict:
    with open(ROOFLINE_SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def validate_roofline(doc: dict) -> List[str]:
    from . import schema as tschema
    return tschema.validate(doc, load_roofline_schema())


# -- the report ---------------------------------------------------------------

def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def find_roofline_files(root: str) -> List[str]:
    """Every ``_roofline*.json`` under ``root``, or the file itself when
    ``root`` is one."""
    from pathlib import Path
    p = Path(root)
    if p.is_file():
        return [str(p)]
    return [str(q) for q in sorted(p.rglob("_roofline*.json"))]


def aggregate_rooflines(root: str) -> Optional[dict]:
    """Merge every roofline artifact under ``root`` into one per-family view
    (flops and seconds summed across hosts, effective TFLOPS, MFU and the
    verdict recomputed from the sums). None when there is no artifact."""
    docs = [d for d in (_load_json(p) for p in find_roofline_files(root))
            if d is not None and d.get("schema") == SCHEMA_VERSION]
    if not docs:
        return None
    device = docs[0].get("device") or {}
    fams: Dict[str, Dict[str, float]] = {}
    for doc in docs:
        for fam, f in (doc.get("families") or {}).items():
            agg = fams.setdefault(fam, {
                "flops_total": 0.0, "bytes_total": 0.0, "dispatches": 0,
                "forward_s": 0.0, "h2d_s": 0.0, "wall_s": 0.0, "hosts": 0})
            for k in ("flops_total", "bytes_total", "forward_s", "h2d_s",
                      "wall_s"):
                agg[k] += float(f.get(k) or 0.0)
            agg["dispatches"] += int(f.get("dispatches") or 0)
            agg["hosts"] += 1
    peak_tf = device.get("peak_tflops")
    peak_gb = device.get("peak_gbps")
    out = {}
    for fam, a in fams.items():
        eff = (a["flops_total"] / 1e12 / a["forward_s"]
               if a["forward_s"] > 0 and a["flops_total"] else None)
        out[fam] = {
            **{k: round(v, 6) if isinstance(v, float) else v
               for k, v in a.items()},
            "arithmetic_intensity": (
                round(a["flops_total"] / a["bytes_total"], 3)
                if a["bytes_total"] else None),
            "effective_tflops": round(eff, 4) if eff is not None else None,
            "mfu": (round(eff / peak_tf, 4)
                    if eff is not None and peak_tf else None),
            "device_share": (round(a["forward_s"] / a["wall_s"], 4)
                             if a["wall_s"] else None),
            "verdict": classify(a["flops_total"], a["bytes_total"],
                                a["forward_s"], a["wall_s"], peak_tf,
                                peak_gb),
        }
    return {"device": device, "families": out, "n_artifacts": len(docs)}


def render_verdict(verdict: Optional[str]) -> str:
    if verdict == "host-bound":
        return "host-bound (sandbagged)"
    return verdict or "?"


def render_table(agg: dict) -> List[str]:
    dev = agg.get("device") or {}
    lines = [
        "== roofline (per-family MFU) ==",
        f"  device: {dev.get('device_kind')} ({dev.get('platform')})  "
        f"peak={dev.get('peak_tflops')} TFLOPS"
        + (f" / {dev.get('peak_gbps')} GB/s" if dev.get("peak_gbps")
           else "")
        + f"  [{dev.get('source')}]",
        f"  {'family':<12} {'GFLOP':>10} {'AI':>7} {'disp':>6} "
        f"{'fwd s':>8} {'eff TFLOPS':>11} {'MFU':>7} {'dev%':>6}  verdict",
    ]
    for fam, f in sorted((agg.get("families") or {}).items()):
        mfu = f.get("mfu")
        share = f.get("device_share")
        eff = f.get("effective_tflops")
        lines.append(
            f"  {fam:<12} {f.get('flops_total', 0) / 1e9:>10.1f} "
            f"{f.get('arithmetic_intensity') or 0:>7.1f} "
            f"{f.get('dispatches', 0):>6} "
            f"{f.get('forward_s', 0):>8.2f} "
            f"{eff if eff is not None else float('nan'):>11.4f} "
            f"{(100 * mfu if mfu is not None else float('nan')):>6.2f}% "
            f"{(100 * share if share is not None else float('nan')):>5.1f}%"
            f"  {render_verdict(f.get('verdict'))}")
    return lines


def _profiler_op_table(profile_dir: str, top: int = 10) -> List[str]:
    """Device time by kernel name from the newest ``torch.profiler`` Chrome
    trace under ``profile_dir`` (``profile_trace_dir=``: its
    ``*.pt.trace.json``): the ``kernel`` events where the trace has any
    (the card's), else every complete event (a CPU capture)."""
    import glob
    import gzip
    cands = sorted(
        glob.glob(os.path.join(profile_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(profile_dir, "**", "*.trace.json"),
                    recursive=True),
        key=os.path.getmtime)
    if not cands:
        return [f"  (no *.trace.json[.gz] under {profile_dir})"]
    path = cands[-1]
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"  (unreadable profiler trace {path}: "
                f"{type(e).__name__}: {e})"]
    events = [ev for ev in doc.get("traceEvents", [])
              if isinstance(ev, dict) and ev.get("ph") == "X"
              and isinstance(ev.get("dur"), (int, float))]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    totals: Dict[str, float] = {}
    for ev in kernels or events:
        name = str(ev.get("name", "?"))
        totals[name] = totals.get(name, 0.0) + float(ev["dur"])
    if not totals:
        return [f"  (no complete events in {path})"]
    acc = sum(totals.values())
    lines = [f"== per-op breakdown ({os.path.basename(path)}"
             + (", device kernels" if kernels else "") + ") ==",
             f"  {'ms':>10} {'share':>7}  op"]
    for name, us in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {us / 1e3:>10.1f} {100 * us / acc:>6.1f}%  "
                     f"{name[:90]}")
    return lines


def report_main(argv: Optional[List[str]] = None) -> int:
    """``python -m video_features_tpu_torch.telemetry.roofline <output_dir>
    [--profile DIR] [--top N] [--json] [--calibrate]``: the per-family MFU
    table and verdicts of a run's ``_roofline*.json``, optionally with the
    per-kernel device time of a ``torch.profiler`` capture."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description="per-family MFU table + roofline verdicts from "
                    "_roofline.json artifacts (roofline=true runs)")
    ap.add_argument("root", nargs="?", default=None,
                    help="a roofline=true run's output dir (or a fleet "
                         "root, or a _roofline.json file)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run measure_peak() NOW on an idle card and "
                         "overwrite this device kind's cached peak")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also render a per-kernel device-time table from "
                         "a torch.profiler capture (profile_trace_dir=)")
    ap.add_argument("--top", type=int, default=10,
                    help="ops to list under --profile (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="print the aggregated document as JSON instead "
                         "of the table")
    args = ap.parse_args(argv)
    if args.calibrate:
        kind, _ = _local_device()
        m = measure_peak()
        path = _peak_cache_path(kind, None)
        write_json_atomic(path, {**m, "device_kind": kind,
                                 "time": round(time.time(), 3)})
        print(f"roofline: calibrated {kind}: "
              f"{m['peak_tflops']} TFLOPS / {m['peak_gbps']} GB/s "
              f"-> {path}")
        if args.root is None:
            return 0
    if args.root is None:
        ap.error("an output dir is required unless --calibrate ran alone")
    agg = aggregate_rooflines(args.root)
    if agg is None:
        print(f"roofline: no {ROOFLINE_FILENAME} under {args.root} — "
              "was the run launched with roofline=true?", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(agg, indent=1, sort_keys=True))
    else:
        print("\n".join(render_table(agg)))
    if args.profile:
        print("\n".join(_profiler_op_table(args.profile, args.top)))
    return 0


if __name__ == "__main__":
    raise SystemExit(report_main())
