"""Extraction lifecycle shared by the port's families (port of
``video_features_tpu/extractors/base.py``): ``_extract`` = skip-if-exists ->
``extract`` -> sink dispatch; device and precision resolution; weights; the
data mesh of the runners (:meth:`BaseExtractor._data_mesh`) and their
result streams (:meth:`BaseExtractor.feature_stream`); the
``resize=auto|host|device`` choice and the per-resolution, per-device
resizer cache; the decode source of ``video_decode``
(:meth:`BaseExtractor.video_source`)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config, check_ported
from ..device import resolve_device, set_precision
from ..ops import preprocess as pp
from ..parallel.mesh import DataParallelApply, FeatureStream, Mesh, get_mesh
from ..utils import faults, sinks
from ..utils import io as vio
from ..weights.bridge import seeded_init_

_RESIZE_CACHE_SIZE = 8


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
    ``path`` is unset and ``allow_random`` is true."""
    if path:
        module.load_state_dict(read_state_dict(path), strict=True)
        return module
    if not allow_random:
        raise FileNotFoundError(
            f"no checkpoint for {what}: pass its weights path, or "
            "allow_random_weights=true for a seeded random init")
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
        self.args = args
        self._mesh = mesh

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
        its deadline watchdog can cancel it."""
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
        src = cls(video_path, **kwargs)
        if ctx is not None:
            ctx.register(src)
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

    def _extract(self, video_path: str) -> Optional[Dict[str, np.ndarray]]:
        if sinks.is_already_exist(self.on_extraction, self.output_path,
                                  video_path, self.output_feat_keys):
            return None
        feats = self.extract(video_path)
        self.action_on_extraction(feats, video_path)
        return feats

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def action_on_extraction(self, feats: Dict[str, np.ndarray],
                             video_path: str) -> None:
        # re-check before writing: another worker may have just written it
        if self.on_extraction != "print" and sinks.is_already_exist(
                self.on_extraction, self.output_path, video_path,
                self.output_feat_keys):
            return
        sinks.action_on_extraction(feats, video_path, self.output_path,
                                   self.on_extraction)
