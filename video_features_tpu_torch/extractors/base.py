"""Extraction lifecycle shared by the port's families (port of
``video_features_tpu/extractors/base.py``): ``_extract`` = cache hit ->
skip-if-exists -> ``extract`` -> sink dispatch -> cache store; device and
precision resolution; the capture of the weights the store resolved
(``weights/store.py``) for the cache key; the
data mesh of the runners (:meth:`BaseExtractor._data_mesh`) and their
result streams (:meth:`BaseExtractor.feature_stream`); the
``resize=auto|host|device`` choice and the per-resolution, per-device
resizer cache; the decode source of ``video_decode``, or of a multi-family
run's shared decode (:meth:`BaseExtractor.video_source`); and ``health=true``,
the digest and non-finite gate of every output at the sink
(``telemetry/health.py``); ``parity=true``, the per-seam digests of
``telemetry/parity.py`` (decode and transform through the source's
transform, head at the sink; each family taps its backbone); and, for a
caller that drives ``_extract`` without the CLI, ``roofline=true``'s
observer (``telemetry/roofline.py ensure_for_extractor``). With telemetry
on, the span of the video in
progress gets the source's ``video_fps`` and ``video_frames`` and a
``source`` event, a private source's probing is a ``source_probe`` trace
span, and the cache's work is counted (``vft_cache_{hit,miss,bypass,
store_failures}_total{family}``)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

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
from ..weights.store import start_weights_capture

_RESIZE_CACHE_SIZE = 8

class BaseExtractor:
    output_feat_keys: List[str]
    #: un-materialized outputs a video's :class:`FeatureStream` may hold
    stream_depth = 4
    #: ``fps_mode`` and ``keep_tmp_files`` (set from the config):
    #: ``reencode`` decodes the reference's lossy re-encode of each video,
    #: written under ``tmp_path`` (``utils/io.py``) and kept with
    #: ``keep_tmp_files``
    fps_mode = "select"
    keep_tmp_files = False

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
        self.show_pred = bool(args.get("show_pred", False))
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
        self.fps_mode = args.get("fps_mode") or "select"
        self.keep_tmp_files = bool(args.get("keep_tmp_files", False))
        # health=true: digest every output at the sink into
        # {output_path}/_health.jsonl and refuse non-finite ones
        self.health = bool(args.get("health", False))
        # parity=true: per-seam digests into {output_path}/_parity.jsonl;
        # off, the transform wrapper is never installed and each tap is
        # this attribute's read
        self.parity = bool(args.get("parity", False))
        # roofline=true for a caller that never went through cli.py: an
        # observer homed on output_path, made on the first _extract
        self._roofline_checked = False
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
        ``decode_depth``), built with ``kwargs``; under
        ``fps_mode=reencode`` with ``tmp_path`` and ``keep_tmp_files``
        (the spawned sources refuse it). Inside a
        :class:`utils.faults.FaultContext` the context's
        ``decode_override`` (the ladder's rung for a retry) replaces
        ``video_decode``, and the source is registered with the context so
        its deadline watchdog can cancel it.

        Inside a multi-family run (a ``parallel/fanout.py``
        ``SharedDecodeSession`` on this thread) the first attempt
        subscribes to the video's one shared decode and gets a
        ``SharedFrameSource`` with the same surface, registered with the
        context by the bus; a declined subscription (a retry) falls
        through to a private source.

        With ``parity=true`` the host transform is wrapped in a
        ``telemetry/parity.py TransformTap`` (the decode and transform
        seams) before the subscribe, so the shared and private sources tap
        alike on this family's thread."""
        if self.parity:
            from ..telemetry import parity
            kwargs["transform"] = parity.TransformTap(
                kwargs.get("transform"), str(video_path), self.feature_type)
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
        if self.fps_mode == "reencode":
            kwargs.setdefault("fps_mode", "reencode")
            kwargs.setdefault("tmp_path", self.tmp_path)
            kwargs.setdefault("keep_tmp", self.keep_tmp_files)
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

    def _host_resize_for_show_pred(self) -> None:
        """``show_pred`` shows or scores the resized frames on the host,
        which it no longer has under ``resize=device``: warn and resize on
        the host, as the JAX package does."""
        if self.resize_mode == "device" and self.show_pred:
            print("WARNING: resize=device is unsupported with show_pred; "
                  "using resize=host")
            self.resize_mode = "host"

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
        if not self._roofline_checked:
            self._roofline_checked = True
            from ..telemetry.roofline import ensure_for_extractor
            ensure_for_extractor(self)
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

    def tap_backbone(self, outs: List[np.ndarray],
                     video: Optional[str]) -> None:
        """With ``parity=true`` and a ``video``: each result as it came off
        the card is a backbone-seam record, indexed by its position."""
        if self.parity and video is not None:
            from ..telemetry import parity
            for index, out in enumerate(outs):
                parity.tap("backbone", self.feature_type, out,
                           video=str(video), feature_type=self.feature_type,
                           index=index)

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
        if self.parity:
            # the head seam: each output as the sink is about to write it
            from ..telemetry import parity
            for key in sorted(feats):
                parity.tap("head", key, feats[key], video=str(video_path),
                           feature_type=self.feature_type)
        # re-check before writing: another worker may have just written it
        if self.on_extraction != "print" and sinks.is_already_exist(
                self.on_extraction, self.output_path, video_path,
                self.output_feat_keys):
            return
        sinks.action_on_extraction(feats, video_path, self.output_path,
                                   self.on_extraction)
