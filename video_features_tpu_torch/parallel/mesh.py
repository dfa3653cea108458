"""Device mesh and data-parallel batch execution (port of
``video_features_tpu/parallel/mesh.py``).

  - single host: a batch's rows are split in order over the mesh's ``data``
    devices, each of which holds a replica of the module; nothing crosses
    between them (extraction is data-parallel at clip granularity);
  - multi host: one process per host, each with a mesh over its own cards;
    the work list is split by :func:`local_shard_of_list` (``md5(stem) %
    world_size``), the only thing the processes share.

:class:`Mesh` is a list of ``torch.device`` shaped ``(data,)`` or ``(data,
model)``. On the CPU, ``get_mesh("cpu", n_devices=N)`` gives N replicas on
the CPU: the counterpart of the JAX tests' virtual CPU devices, which is how
the CPU tests hold the multi-device path. ``get_mesh(devices=[...])`` takes
an explicit list (two replicas on one card stand in for two cards).

No padding: eager PyTorch has no static shapes, so a ragged batch runs as it
is and JAX's wire buckets (``padded_batch_size``, ``bucket_batch_size``,
``_pad``) have no counterpart. ``torch.nn.DataParallel`` is not used: it
scatters through card 0 and gathers onto it, which the JAX mesh does not.

CLIP's ``model_parallel`` puts a second, ``model`` axis on the mesh: the
module is cut by :data:`TP_RULES_TRANSFORMER` (:func:`param_specs_by_rules`,
:func:`shard_tensor`) and each data row runs the tensor-parallel forward of
``models/clip.py`` over its model-axis devices.

Profiler stages (``utils/profiling.py``; they add no synchronize and no
blocking copy): ``h2d`` times :func:`to_device` of each chunk of a host
batch in :meth:`DataParallelApply.dispatch`, that is the pinned staging
copy and the enqueue of the non-blocking transfer, a lower bound on the
wire time, as JAX's ``device_put``. ``forward`` times the host's wait
for a result, in :meth:`DataParallelApply.__call__` and, under
:class:`FeatureStream`, in ``_pop``: it is the host's *stall* on the card,
not device time, as in the JAX package, and near zero means decode hides
the card's work. The launch of a forward is in no stage (eager PyTorch
enqueues each kernel from the host, and on the CPU the launch is the
computation; a span's wall less its stages shows that time).
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import re
from collections import deque
from pathlib import Path
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn

from ..utils.profiling import profiler

Batch = Union[np.ndarray, torch.Tensor]


class Mesh:
    """``devices`` (flat, row-major) shaped ``shape`` over ``axis_names``.
    ``rows`` are the model-axis groups: one per data index, whose first
    device (the row's data device) receives the row's share of a batch."""

    def __init__(self, devices: Sequence[torch.device],
                 shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...] = ("data",)) -> None:
        if len(shape) != len(axis_names) or int(np.prod(shape)) != \
                len(devices) or len(shape) not in (1, 2):
            raise ValueError(f"mesh shape {shape} over {axis_names} does not "
                             f"fit {len(devices)} device(s)")
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        per_row = shape[1] if len(shape) == 2 else 1
        self.rows = [self.devices[i:i + per_row]
                     for i in range(0, len(self.devices), per_row)]

    @property
    def data_devices(self) -> List[torch.device]:
        return [row[0] for row in self.rows]

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(device: Union[str, torch.device, None] = "cuda",
             n_devices: Optional[int] = None,
             axis_names: Tuple[str, ...] = ("data",),
             shape: Optional[Tuple[int, ...]] = None,
             devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh over ``device``'s devices: ``cuda`` (or ``auto``) every visible
    card, ``cuda:N`` that card alone, ``cpu`` one CPU device; ``n_devices``
    takes the first N (on the CPU, N replicas). A request for more cards
    than exist takes what exists and prints the width it took. ``devices``
    names the devices outright (tests, ``chip_smoke.py``)."""
    if devices is None:
        dev = torch.device("cuda" if device in (None, "auto") else device)
        if dev.type == "cpu":
            devices = [dev] * (1 if n_devices is None else int(n_devices))
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(f"a mesh on {dev} needs a CUDA device")
            devices = ([dev] if dev.index is not None else
                       [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())])
            if n_devices is not None:
                if int(n_devices) > len(devices):
                    print(f"mesh_devices={n_devices}: {len(devices)} card(s) "
                          f"visible; the mesh takes {len(devices)}")
                devices = devices[:int(n_devices)]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(devices, tuple(shape), axis_names)


def mesh_topology() -> dict:
    """JSON-safe device and mesh snapshot, with the JAX function's keys:
    what this process saw (the cards, or the CPU), and its rank and world
    size (``torch.distributed`` when it is initialized, else 0 and 1)."""
    rank, world = _rank_and_world()
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        kinds = sorted({torch.cuda.get_device_name(i) for i in range(n)})
        platform = "gpu"
    else:
        n, kinds, platform = 1, ["cpu"], "cpu"
    return {"platform": platform, "device_kinds": kinds,
            "n_local_devices": n, "n_global_devices": n * world,
            "process_index": rank, "process_count": world,
            "default_mesh_axes": {"data": n}}


def _rank_and_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_shard_of_list(items: Sequence[str], host_id: Optional[int] = None,
                        num_hosts: Optional[int] = None) -> List[str]:
    """Deterministic item->host assignment: ``md5(stem) % num_hosts`` (the
    JAX function's hash; ``host_id`` and ``num_hosts`` default to the
    ``torch.distributed`` rank and world size, 0 and 1 without it). Stable
    across restarts, so a rerun resumes; stems, not paths, so hosts may
    mount the shared filesystem under different prefixes."""
    if host_id is None or num_hosts is None:
        rank, world = _rank_and_world()
        host_id = rank if host_id is None else host_id
        num_hosts = world if num_hosts is None else num_hosts
    if num_hosts <= 1:
        return list(items)
    out = []
    for it in items:
        stem = Path(str(it)).stem
        h = int(hashlib.md5(stem.encode()).hexdigest(), 16)
        if h % num_hosts == host_id:
            out.append(it)
    return out


#: Megatron-style tensor-parallel rules for the transformer blocks and the
#: attention-pool head of ``models/clip.py`` (parameter names as in the
#: reference checkpoint): ``qkv`` splits the packed (3E, E) ``in_proj``
#: within each of q, k and v; ``column`` splits the output rows (weight dim
#: 0 and the bias); ``row`` splits the input columns (weight dim 1; the
#: bias is added once, after the partial sums). First match wins; every
#: other tensor is replicated.
TP_RULES_TRANSFORMER: Tuple[Tuple[str, str], ...] = (
    (r"attn\.in_proj_(weight|bias)$", "qkv"),
    (r"mlp\.c_fc\.(weight|bias)$", "column"),
    (r"attn\.out_proj\.weight$", "row"),
    (r"mlp\.c_proj\.weight$", "row"),
    (r"attnpool\.(q|k|v)_proj\.(weight|bias)$", "column"),
    (r"attnpool\.c_proj\.weight$", "row"),
)


def param_specs_by_rules(module: nn.Module,
                         rules: Sequence[Tuple[str, str]]
                         ) -> Dict[str, str]:
    """``{parameter name: split kind}`` for every parameter of ``module``
    that a rule matches (the first match wins); the others are left out,
    which means replicated."""
    specs = {}
    for name, _ in module.named_parameters():
        for pattern, kind in rules:
            if re.search(pattern, name):
                specs[name] = kind
                break
    return specs


def split_bounds(width: int, n: int, heads: int = 0) -> List[Tuple[int, int]]:
    """``n`` contiguous ``[a, b)`` pieces of ``width``: whole heads each
    where ``heads % n == 0``, else as even as ``np.array_split`` makes
    them."""
    if heads and heads % n == 0:
        step = width // n
        return [(i * step, (i + 1) * step) for i in range(n)]
    edges = np.cumsum([0] + [len(p) for p in np.array_split(
        np.arange(width), n)])
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def shard_tensor(t: torch.Tensor, kind: str,
                 bounds: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``t`` cut by ``kind`` (:data:`TP_RULES_TRANSFORMER`) into one piece
    per ``[a, b)`` of ``bounds``: ``column`` rows ``a:b``; ``qkv`` rows
    ``a:b`` of each third, concatenated; ``row`` columns ``a:b``."""
    if kind == "column":
        return [t[a:b].clone() for a, b in bounds]
    if kind == "qkv":
        q, k, v = t.chunk(3, dim=0)
        return [torch.cat([q[a:b], k[a:b], v[a:b]]) for a, b in bounds]
    if kind == "row":
        return [t[:, a:b].clone() for a, b in bounds]
    raise ValueError(f"unknown split kind {kind!r}")


def settle(out: Any, mesh: Optional[Mesh] = None) -> float:
    """Completion fence: synchronizes every card of ``mesh`` and of the
    tensors in ``out`` (a tensor, array, or list, tuple or dict of them),
    then sums every value on the host."""
    leaves = _leaves(out)
    cards = {d for d in (mesh.devices if mesh else []) if d.type == "cuda"}
    cards |= {t.device for t in leaves
              if torch.is_tensor(t) and t.device.type == "cuda"}
    for d in cards:
        torch.cuda.synchronize(d)
    return float(sum(
        (t.double().sum().item() if torch.is_tensor(t)
         else np.asarray(t, np.float64).sum()) for t in leaves))


def _leaves(out: Any) -> list:
    if isinstance(out, dict):
        return [x for v in out.values() for x in _leaves(v)]
    if isinstance(out, (list, tuple)):
        return [x for v in out for x in _leaves(v)]
    return [out]


def to_device(batch: Batch, device: torch.device) -> torch.Tensor:
    """Host array or tensor -> tensor on ``device``: one copy, pinned and
    non-blocking from the host to a card (the caching host allocator keeps
    the pinned buffer until the copy is done), device to device for a
    tensor already on a card."""
    t = torch.from_numpy(np.ascontiguousarray(batch)) \
        if isinstance(batch, np.ndarray) else batch
    if t.device == device:
        return t
    if device.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def _on(device: torch.device):
    """``torch.cuda.device(device)`` for a card (the current device is
    thread-local: a worker thread starts on card 0), nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


class DataParallelApply:
    """``apply_fn(replica, batch)`` over the mesh's data devices, the
    counterpart of JAX's ``apply_fn(params, batch)``.

    One replica of ``module`` per data device: the module itself on the
    first (moved there), ``copy.deepcopy`` copies on the others. With
    ``shard``, a data row's replica is ``shard(module, row_devices)``
    instead (tensor parallelism over the ``model`` axis). A batch's rows are
    split in order over the devices (``np.array_split``; a device that gets
    no row is skipped) and each chunk's forward is launched on its device
    without waiting for it."""

    def __init__(self, apply_fn: Callable[[nn.Module, torch.Tensor],
                                          torch.Tensor],
                 module: nn.Module, mesh: Optional[Mesh] = None,
                 shard: Optional[Callable[[nn.Module, List[torch.device]],
                                          nn.Module]] = None) -> None:
        self.mesh = mesh if mesh is not None else get_mesh()
        self.apply_fn = apply_fn
        self.devices = self.mesh.data_devices
        if shard is not None:
            self.replicas = [shard(module, row) for row in self.mesh.rows]
        else:
            copies = [copy.deepcopy(module) for _ in self.devices[1:]]
            self.replicas = [m.to(d) for m, d in
                             zip([module] + copies, self.devices)]

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def with_fn(self, apply_fn: Callable) -> "DataParallelApply":
        """Another function over the same replicas (no second copy of the
        weights)."""
        other = copy.copy(self)
        other.apply_fn = apply_fn
        return other

    def dispatch(self, batch: Batch) -> List[torch.Tensor]:
        """Launch the forward of each device's chunk; returns the chunks'
        outputs in row order WITHOUT synchronizing. A host batch crosses
        to each card in one pinned copy; a tensor already on a card (a
        chained stage) is split and moved between cards on the device."""
        n = batch.shape[0]
        sizes = [len(p) for p in np.array_split(np.arange(n),
                                                len(self.devices))]
        host = isinstance(batch, np.ndarray) or batch.device.type == "cpu"
        outs, start = [], 0
        for replica, dev, size in zip(self.replicas, self.devices, sizes):
            if size == 0 and (n or outs):
                continue  # an empty batch still runs once, on device 0
            with _on(dev), torch.inference_mode():
                chunk = batch[start:start + size]
                if host:
                    with profiler.stage("h2d"):
                        chunk = to_device(chunk, dev)
                else:
                    chunk = to_device(chunk, dev)
                outs.append(self.apply_fn(replica, chunk))
            start += size
        return outs

    def __call__(self, batch: Batch, n_valid: Optional[int] = None
                 ) -> np.ndarray:
        """Run a batch; returns its first ``n_valid`` (all) rows on the
        host."""
        n = batch.shape[0] if n_valid is None else n_valid
        outs = self.dispatch(batch)
        with profiler.stage("forward"):
            return to_host(outs)[:n]

    def stream(self, depth: int = 4,
               callback: Optional[Callable[[np.ndarray, Any], None]] = None
               ) -> "FeatureStream":
        return FeatureStream(self, depth=depth, callback=callback)


def to_host(out: Any) -> np.ndarray:
    """The blocking read of a dispatched output (a tensor or a list of
    chunks, concatenated in order, through :class:`_HostCopy`); anything
    else through ``np.asarray``, which raises what a failed computation
    raises."""
    if torch.is_tensor(out) or isinstance(out, (list, tuple)):
        return _HostCopy(out).wait()
    return np.asarray(out)


class _HostCopy:
    """The D2H copies of one dispatched output, in flight: each card chunk
    into pinned host memory with ``non_blocking=True``, and one
    ``torch.cuda.Event`` after each. :meth:`wait` synchronizes the events
    before reading the buffers, which hold garbage until then."""

    def __init__(self, out: Union[torch.Tensor, Sequence[torch.Tensor]]
                 ) -> None:
        chunks = [out] if torch.is_tensor(out) else list(out)
        self.parts = []
        for c in chunks:
            if c.device.type != "cuda":
                self.parts.append((c, None, None))
                continue
            with torch.cuda.device(c.device):
                host = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                host.copy_(c, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            # the device chunk stays referenced until the copy is read
            self.parts.append((host, event, c))

    def wait(self) -> np.ndarray:
        arrays = []
        for host, event, _ in self.parts:
            if event is not None:
                event.synchronize()
            arrays.append(host.numpy())
        return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)


class FeatureStream:
    """Ordered async pipeline over a :class:`DataParallelApply`.

    ``submit`` dispatches a batch and starts its copy back to pinned host
    memory, so decode of batch k+1, the forward of batch k and the D2H of
    the batches before overlap; ``finish`` returns every result in submit
    order. ``depth`` bounds the un-materialized outputs exactly: the oldest
    is materialized *before* a new batch is dispatched at capacity. 0 means
    synchronous: each submit materializes its result before returning.
    ``callback(feats, ctx)`` fires at materialization, in submit order,
    with the valid rows and the ``ctx`` passed to ``submit`` (show_pred).
    """

    def __init__(self, runner: Optional[DataParallelApply], depth: int = 4,
                 callback: Optional[Callable[[np.ndarray, Any], None]] = None
                 ) -> None:
        self.runner = runner
        self.depth = max(int(depth), 0)
        self.callback = callback
        self._inflight: deque = deque()  # (_HostCopy, n_valid, ctx)
        self._done: List[np.ndarray] = []

    def submit(self, batch: Batch, n_valid: Optional[int] = None,
               ctx: Any = None) -> None:
        n = batch.shape[0] if n_valid is None else n_valid
        while self._inflight and len(self._inflight) >= self.depth:
            self._pop()  # drain BEFORE dispatching: the bound holds
        self.submit_device(self.runner.dispatch(batch), n, ctx)

    def submit_device(self, dev: Union[torch.Tensor, Sequence[torch.Tensor]],
                      n_valid: int, ctx: Any = None) -> None:
        """Enqueue an already dispatched output (a tensor or a list of
        chunks); the stream still bounds retained results and materializes
        in order. A runner-less stream (``FeatureStream(None, ...)``)
        supports only this entry point."""
        if self.callback is None:
            ctx = None  # do not pin (possibly large) host batches
        while self._inflight and len(self._inflight) >= max(self.depth, 1):
            self._pop()
        self._inflight.append((_HostCopy(dev), n_valid, ctx))
        if self.depth == 0:
            self._pop()

    def _pop(self) -> None:
        pending, n, ctx = self._inflight.popleft()
        # the host's stall until the oldest result lands (module docstring)
        with profiler.stage("forward"):
            feats = pending.wait()[:n]
        if self.callback is not None:
            self.callback(feats, ctx)
        self._done.append(feats)

    def finish(self) -> List[np.ndarray]:
        """Materialize every pending result; returns them in submit
        order."""
        while self._inflight:
            self._pop()
        done, self._done = self._done, []
        return done
