"""Extraction lifecycle shared by the port's families (port of
``video_features_tpu/extractors/base.py``): ``_extract`` = cache hit ->
skip-if-exists -> ``extract`` -> sink dispatch -> cache store; device and
precision resolution; weights and their capture for the cache key; the
data mesh of the runners (:meth:`BaseExtractor._data_mesh`) and their
result streams (:meth:`BaseExtractor.feature_stream`); the
``resize=auto|host|device`` choice and the per-resolution, per-device
resizer cache; the decode source of ``video_decode``, or of a multi-family
run's shared decode (:meth:`BaseExtractor.video_source`); and ``health=true``,
the digest and non-finite gate of every output at the sink
(``telemetry/health.py``). With telemetry on, the span of the video in
progress gets the source's ``video_fps`` and ``video_frames`` and a
``source`` event, a private source's probing is a ``source_probe`` trace
span, and the cache's work is counted (``vft_cache_{hit,miss,bypass,
store_failures}_total{family}``)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import telemetry
from ..config import Config, check_ported
from ..device import resolve_device, set_precision
from ..ops import preprocess as pp
from ..parallel import fanout
from ..parallel.mesh import DataParallelApply, FeatureStream, Mesh, get_mesh
from ..telemetry import trace
from ..utils import faults, sinks
from ..utils import io as vio
from ..utils.profiling import profiler
from ..weights.bridge import seeded_init_

_RESIZE_CACHE_SIZE = 8

_capture_tls = threading.local()


def start_weights_capture() -> list:
    """Begin a fresh capture of weights resolutions on this thread; returns
    the live list that later :func:`record_weights` calls on this thread
    append to (the JAX package's ``weights/store.py``
    ``start_weights_capture``)."""
    cap: list = []
    _capture_tls.capture = cap
    return cap


def record_weights(model_key: str, path: Optional[str]) -> None:
    """Record what an extractor loaded for ``model_key``, under the JAX
    package's model keys: ``{model_key, path, sha256}`` for a checkpoint
    file, ``{model_key, random: True}`` for the seeded init."""
    cap = getattr(_capture_tls, "capture", None)
    if cap is None:
        return
    if not path:
        cap.append({"model_key": model_key, "random": True})
        return
    from ..cache import file_sha256
    try:
        cap.append({"model_key": model_key, "path": str(path),
                    "sha256": file_sha256(str(path))})
    except OSError:
        pass  # keying metadata: an unreadable file fails its load instead


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file's state dict on the CPU: ``torch.load`` (weights
    only), or for a TorchScript archive, which it refuses (OpenAI ships
    CLIP as ``.pt`` JIT archives), ``torch.jit.load(...).state_dict()``;
    common containers (``state_dict``, ``model_state_dict``,
    ``model``) unwrapped, a ``module.`` prefix dropped, float16 tensors
    upcast to float32 (reference clip.py:128-139)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except RuntimeError:  # a TorchScript archive
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict", "model"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    return {(k[len("module."):] if k.startswith("module.") else k):
            (v.float() if torch.is_tensor(v) and v.dtype == torch.float16
             else v) for k, v in obj.items()}


def load_weights(module: nn.Module, path: Optional[str], allow_random: bool,
                 seed: int, what: str) -> nn.Module:
    """Load a checkpoint in the reference's torch key layout into
    ``module`` (``strict=True``), or give it the seeded random init when
    ``path`` is unset and ``allow_random`` is true; ``what`` is the JAX
    package's model key, recorded for the cache key
    (:func:`record_weights`)."""
    if path:
        record_weights(what, path)
        module.load_state_dict(read_state_dict(path), strict=True)
        return module
    if not allow_random:
        raise FileNotFoundError(
            f"no checkpoint for {what}: pass its weights path, or "
            "allow_random_weights=true for a seeded random init")
    record_weights(what, None)
    return seeded_init_(module, seed)


class BaseExtractor:
    output_feat_keys: List[str]
    #: un-materialized outputs a video's :class:`FeatureStream` may hold
    stream_depth = 4
    show_pred = False

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        """``mesh`` replaces the mesh of ``device`` and ``mesh_devices``
        (tests and ``chip_smoke.py`` put two replicas on one card)."""
        check_ported(args)
        self.feature_type = args.feature_type
        self.on_extraction = args.get("on_extraction", "print")
        self.output_path = str(args.output_path)
        self.tmp_path = str(args.tmp_path)
        self.device = resolve_device(args.get("device"))
        self.precision = args.get("precision") or "float32"
        self.dtype = set_precision(self.precision, self.feature_type)
        self.allow_random = bool(args.get("allow_random_weights", False))
        # video_decode (the JAX package's semantics): where a video's
        # decode and host transform run; decode_workers is the width of
        # 'parallel', decode_depth each child's frame-queue cap
        self.video_decode = args.get("video_decode") or "inline"
        raw_dw = args.get("decode_workers")
        self.decode_workers = 2 if raw_dw is None else int(raw_dw)
        if self.decode_workers < 1:
            raise ValueError(
                f"decode_workers={self.decode_workers}: need >= 1")
        raw_dd = args.get("decode_depth")
        self.decode_depth = None if raw_dd is None else int(raw_dd)
        # health=true: digest every output at the sink into
        # {output_path}/_health.jsonl and refuse non-finite ones
        self.health = bool(args.get("health", False))
        self.args = args
        self._mesh = mesh
        # cache=true: the capture starts before the subclass loads its
        # weights; the cache handle is built on the first _extract, once
        # the resolved attributes (resize_mode, ingest) exist
        self.cache_enabled = bool(args.get("cache", False))
        if self.cache_enabled:
            self._weights_capture = start_weights_capture()
        self._cache = None
        self._cache_built = False

    def _data_mesh(self) -> Mesh:
        """The mesh of this extractor's runners: the one given to the
        constructor, else ``device``'s (``cuda``: every visible card,
        ``cuda:N``: that card, ``cpu``: one CPU device) cut or, on the CPU,
        widened to ``mesh_devices``."""
        if self._mesh is not None:
            return self._mesh
        n = self.args.get("mesh_devices")
        return get_mesh(self.device, n_devices=None if n is None else int(n))

    def feature_stream(self, runner: DataParallelApply,
                       on_result: Optional[Callable] = None
                       ) -> FeatureStream:
        """An async result stream over ``runner`` of depth
        :attr:`stream_depth`; when ``show_pred`` needs per-batch host
        values it is synchronous (depth 0) with ``on_result`` fired per
        batch: one code path either way."""
        if self.show_pred and on_result is not None:
            return runner.stream(depth=0, callback=on_result)
        return runner.stream(depth=self.stream_depth)

    def video_source(self, video_path: str, **kwargs):
        """The decode source of ``video_decode`` (``inline``:
        :class:`utils.io.VideoSource`, ``process``: ``ProcessVideoSource``,
        ``parallel``: ``ParallelVideoSource`` with ``decode_workers`` and
        ``decode_depth``), built with ``kwargs``. Inside a
        :class:`utils.faults.FaultContext` the context's
        ``decode_override`` (the ladder's rung for a retry) replaces
        ``video_decode``, and the source is registered with the context so
        its deadline watchdog can cancel it.

        Inside a multi-family run (a ``parallel/fanout.py``
        ``SharedDecodeSession`` on this thread) the first attempt
        subscribes to the video's one shared decode and gets a
        ``SharedFrameSource`` with the same surface, registered with the
        context by the bus; a declined subscription (a retry) falls
        through to a private source."""
        session = fanout.current_session()
        if session is not None:
            sub = session.subscribe(self.feature_type, **kwargs)
            if sub is not None:
                if telemetry.current_span() is not None:
                    telemetry.annotate(video_fps=sub.fps,
                                       video_frames=len(sub))
                    telemetry.event("source", mode="shared",
                                    cls=type(sub).__name__)
                return sub
        ctx = faults.current_context()
        mode = self.video_decode
        if ctx is not None and ctx.decode_override:
            mode = ctx.decode_override
        cls = {"process": vio.ProcessVideoSource,
               "parallel": vio.ParallelVideoSource}.get(mode, vio.VideoSource)
        if cls is vio.ParallelVideoSource:
            kwargs.setdefault("decode_workers", self.decode_workers)
            if self.decode_depth is not None:
                kwargs.setdefault("depth", self.decode_depth)
        # probing can be slow (a recount, spawning workers): its own span
        with trace.span("source_probe", video=str(video_path), mode=mode):
            src = cls(video_path, **kwargs)
        if ctx is not None:
            ctx.register(src)
        if telemetry.current_span() is not None:
            # which class served this attempt (the ladder may have demoted
            # it) and the probed properties, for the span's fields
            telemetry.annotate(video_fps=src.fps, video_frames=len(src))
            telemetry.event("source", mode=mode, cls=type(src).__name__)
        return src

    def _resolve_resize_mode(self, args: Config) -> str:
        """``auto`` resolves to ``device`` for file-sink runs and to
        ``host`` for ``print`` and ``show_pred`` runs; ``host``/``device``
        are taken as given."""
        mode = args.get("resize") or "auto"
        if mode not in ("auto", "host", "device"):
            raise NotImplementedError(f"resize={mode!r}: expected 'auto', "
                                      "'host' or 'device'")
        self._resizers: Dict = {}
        self._resize_lock = threading.Lock()
        if mode == "auto":
            mode = ("device" if self.on_extraction in ("save_numpy",
                                                       "save_pickle")
                    and not args.get("show_pred") else "host")
        return mode

    def _edge_resizer(self, in_h: int, in_w: int, size: int,
                      device: torch.device, to_smaller_edge: bool = True,
                      interpolation: str = "bilinear") -> Callable:
        """The resize on ``device`` (PIL's ``interpolation``) of ``(...,
        in_h, in_w, 3)`` uint8 frames to ``size`` on the smaller (or larger)
        edge; built once per source resolution and device (each replica
        resizes on its own), at most 8 kept."""
        key = (in_h, in_w, device)
        with self._resize_lock:
            fn = self._resizers.get(key)
            if fn is None:
                if len(self._resizers) >= _RESIZE_CACHE_SIZE:
                    self._resizers.pop(next(iter(self._resizers)))
                ow, oh = pp.resize_edge_size(in_w, in_h, size,
                                             to_smaller_edge)
                fn = self._resizers[key] = pp.make_device_resizer(
                    in_h, in_w, oh, ow, device, interpolation)
            return fn

    def feature_cache(self):
        """This extractor's ``cache.FeatureCache``, or None under
        ``cache=false``; built once, on first use."""
        if not self._cache_built:
            self._cache_built = True
            if self.cache_enabled:
                from ..cache import FeatureCache
                self._cache = FeatureCache.for_extractor(self)
        return self._cache

    def _extract(self, video_path: str) -> Optional[Dict[str, np.ndarray]]:
        """A cache hit (served through the sink, which still skips files
        that exist), else the filename skip, else extract, sink and store.
        The store comes after the sink, so a failing sink keeps features
        out of the store; a failing store is printed and the video is done
        (its outputs are on disk)."""
        family = str(self.feature_type)
        cache = self.feature_cache()
        if cache is not None:
            feats = cache.lookup(video_path, self.output_feat_keys)
            if feats is not None:
                telemetry.inc("vft_cache_hit_total", family=family)
                self.action_on_extraction(feats, video_path)
                return feats
        if sinks.is_already_exist(self.on_extraction, self.output_path,
                                  video_path, self.output_feat_keys):
            # work avoided without consulting the cache: counted whether
            # cache=true (a miss the filename skip absorbed) or not
            telemetry.inc("vft_cache_bypass_total", family=family)
            return None
        if cache is not None:
            telemetry.inc("vft_cache_miss_total", family=family)
        feats = self.extract(video_path)
        self.action_on_extraction(feats, video_path)
        if cache is not None:
            try:
                cache.store(video_path, feats)
            except Exception as e:
                telemetry.inc("vft_cache_store_failures_total",
                              family=family)
                print(f"cache: store failed for {video_path} "
                      f"({type(e).__name__}: {e}) — features are on disk, "
                      "entry skipped")
        return feats

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def action_on_extraction(self, feats: Dict[str, np.ndarray],
                             video_path: str) -> None:
        if self.health:
            # digest and gate before any write: a non-finite output raises
            # (POISON) after its digest is journaled, so it is quarantined
            # rather than persisted
            from ..telemetry import health
            with profiler.stage("health"):
                health.check_features(feats, video_path, self.feature_type,
                                      self.output_path)
        # re-check before writing: another worker may have just written it
        if self.on_extraction != "print" and sinks.is_already_exist(
                self.on_extraction, self.output_path, video_path,
                self.output_feat_keys):
            return
        sinks.action_on_extraction(feats, video_path, self.output_path,
                                   self.on_extraction)
