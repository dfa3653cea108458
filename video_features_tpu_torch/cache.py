"""Content-addressed feature cache (port of ``video_features_tpu/cache.py``):
a byte-identical rerun is served from the store and never decodes.

With ``cache=true`` a finished extraction is stored once under a key that
captures everything that could change its value, and every later request
for the same (content, configuration, weights) is served from the store
before any decoder is built:

  **content identity**: ``sha256`` of the input file's bytes, memoized per
  ``(path, size, mtime)``; a source whose bytes cannot be read falls back
  to the decode-plan identity (the probed stream properties and the exact
  ``plan_frame_selection`` mapping).

  **config fingerprint**: the sanity-checked config without its
  non-semantic keys (paths, worker counts, retry policy), with the
  extractor's resolved ``resize``/``ingest`` in place of the raw
  ``resize=auto``/``ingest=null`` and ``device`` as its type (``cuda:1``
  computes what ``cuda`` does), so ``resize=auto`` shares entries with the
  value it resolves to.

  **weights fingerprint**: sha256 of every checkpoint the extractor loaded
  (``extractors/base.py load_weights`` records ``{model_key, sha256}``
  under the JAX package's model keys), or a ``random:{model_key}``
  sentinel for the seeded init of ``allow_random_weights``.

  **backend**: ``torch``. The one difference from the JAX package's key:
  the two packages agree within tolerance, not bit for bit, so an entry
  one of them stored in a shared ``cache_dir`` is never served by the
  other. Everything else in the key, and the entry layout
  ``{root}/{family}/{key[:2]}/{key}.pkl``, is the JAX package's.

Serving is verify-before-trust: an entry carries the quantization-tolerant
content signature (``telemetry/health.py content_signature``) of every
tensor, recomputed on load; a torn, stale or corrupted entry is deleted and
reported as a miss. Entries are written atomically (``utils/sinks.py
_write_bytes_atomic``). ``FeatureCache.lookup`` and ``store`` host the
``cache.lookup`` (``torn``: the entry is truncated before it is read) and
``cache.store`` injection sites (``utils/inject.py``).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .telemetry import trace
from .telemetry.health import content_signature

#: schema identifier stamped into every entry (the JAX package's)
SCHEMA_VERSION = "vft.feature_cache/1"

#: the backend component of every entry key
BACKEND = "torch"

#: config keys that never change a feature value: left out of the
#: fingerprint, so runs that differ only in them share entries (the JAX
#: package's set; the port's own keys ``video_decode``, ``mesh_devices``,
#: ``video_workers`` and ``model_parallel`` are among them, as in JAX)
NON_SEMANTIC_KEYS = frozenset({
    "output_path", "tmp_path", "keep_tmp_files",
    "video_paths", "file_with_video_paths", "config",
    "video_workers", "decode_workers", "decode_depth", "video_decode",
    "fanout_depth", "cross_video_batching", "clip_batch_size",
    "batch_size", "flow_stack_batch", "model_parallel",
    "mesh_devices", "distributed",
    "telemetry", "metrics_interval_s", "trace", "health", "parity",
    "roofline", "history", "alerts",
    "profile", "profile_trace_dir", "compilation_cache_dir",
    "retry_attempts", "retry_backoff_s", "video_deadline_s",
    "retry_failed",
    "fleet", "fleet_lease_s", "fleet_max_reclaims", "fleet_canary",
    "cache", "cache_dir", "cache_scope",
    "compile_cache", "compile_cache_dir",
    "inject",
    "spool_dir", "serve_max_pending", "serve_poll_interval_s",
    "serve_idle_exit_s", "serve_max_requests", "serve_workers",
    "serve_warmup_video", "serve_slo_s",
    "gateway_tenants", "gateway_port", "gateway_host",
    "gateway_max_queued", "gateway_spool_bound", "gateway_max_body_mb",
    "gateway_poll_interval_s", "gateway_expire_grace_s",
    "gateway_default_timeout_s",
    "on_extraction", "show_pred",
    "gc", "gc_quota_gb", "gc_cache_retention_s",
    "gc_compile_retention_s", "gc_spool_retention_s",
    "gc_inbox_retention_s", "gc_incident_retention_s",
    "gc_quarantine_retention_s", "gc_staging_retention_s",
    "gc_interval_s",
})

#: config keys that bear on feature values: they stay in the fingerprint
#: (the JAX package's set). Every key of a port YAML is in exactly one of
#: the two sets.
SEMANTIC_KEYS = frozenset({
    "feature_type", "model_name", "device", "precision",
    "weights_path", "allow_random_weights",
    "extraction_fps", "extraction_total", "fps_mode",
    "resize", "ingest", "side_size", "resize_to_smaller_edge",
    "stack_size", "step_size", "streams",
    "flow_type", "flow_iters", "flow_weights_path",
    "flow_model_weights_path", "iters", "finetuned_on",
    "corr_lookup_impl", "fuse_convc1", "vision_attn",
    "bpe_path", "pred_texts",
    "frontend", "postprocess", "pca_weights_path",
})

_sha_lock = threading.Lock()
#: (abspath, size, mtime_ns) -> hex digest; bounded FIFO
_sha_memo: Dict[tuple, str] = {}
_SHA_MEMO_CAP = 4096


def file_sha256(path: str) -> str:
    """Streamed sha256 of a file, memoized on ``(path, size, mtime)``."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    with _sha_lock:
        hit = _sha_memo.get(key)
    if hit is not None:
        return hit
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    with _sha_lock:
        if len(_sha_memo) >= _SHA_MEMO_CAP:
            _sha_memo.pop(next(iter(_sha_memo)), None)
        _sha_memo[key] = digest
    return digest


def plan_identity(video_path: str, fps: Optional[float],
                  total: Optional[int]) -> str:
    """``plan:<hex>``: the probed stream properties and the exact
    frame-selection mapping, for a source whose bytes cannot be hashed."""
    from .utils.io import get_video_props, plan_frame_selection
    props = get_video_props(video_path)
    out_fps, index_map, num_frames = plan_frame_selection(
        props["fps"], props["num_frames"], fps=fps, total=total)
    h = hashlib.sha256()
    h.update(repr((os.path.basename(str(video_path)),
                   round(float(props["fps"]), 4),
                   int(props["num_frames"]),
                   int(props["width"]), int(props["height"]),
                   round(float(out_fps), 4), int(num_frames))).encode())
    if index_map is not None:
        h.update(np.asarray(index_map, np.int64).tobytes())
    return "plan:" + h.hexdigest()


def content_identity(video_path: str, fps: Optional[float] = None,
                     total: Optional[int] = None) -> str:
    """``sha256:<hex>`` of the file's bytes, or :func:`plan_identity` when
    they cannot be read."""
    try:
        return "sha256:" + file_sha256(str(video_path))
    except OSError:
        return plan_identity(video_path, fps, total)


def _plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


def canonical_config(args: Dict[str, Any],
                     resolved: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The value-bearing view of a config: non-semantic keys dropped, the
    ``resolved`` overlays in place of their raw keys."""
    plain = _plain(dict(args))
    out = {k: v for k, v in plain.items() if k not in NON_SEMANTIC_KEYS}
    for k, v in (resolved or {}).items():
        if v is not None:
            out[k] = v
    return out


def config_fingerprint(args: Dict[str, Any],
                       resolved: Optional[Dict[str, Any]] = None) -> str:
    """sha256 over the sorted canonical config's repr."""
    canon = canonical_config(args, resolved)
    blob = repr(sorted(canon.items(), key=lambda kv: kv[0]))
    return hashlib.sha256(blob.encode()).hexdigest()


def weights_fingerprint(capture: Optional[List[dict]]) -> str:
    """sha256 over the sorted identities of the checkpoints an extractor
    loaded (``{model_key}:{sha256}``, or ``random:{model_key}``);
    ``'none'`` for an empty capture."""
    if not capture:
        return "none"
    items = []
    for rec in capture:
        if rec.get("random"):
            items.append(f"random:{rec.get('model_key')}")
        else:
            items.append(f"{rec.get('model_key')}:{rec.get('sha256')}")
    blob = "\n".join(sorted(items))
    return hashlib.sha256(blob.encode()).hexdigest()


def entry_key(content_id: str, config_fp: str, weights_fp: str,
              tenant: Optional[str] = None) -> str:
    """One sha256 over the identity components, the backend and, under
    ``cache_scope=tenant``, the requesting tenant."""
    salt = f"\ntenant:{tenant}" if tenant else ""
    return hashlib.sha256(
        f"{content_id}\n{config_fp}\n{weights_fp}\nbackend:{BACKEND}{salt}"
        .encode()).hexdigest()


def default_cache_dir() -> str:
    return os.environ.get(
        "VFT_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "video_features_tpu", "feature_cache"))


class FeatureCache:
    """One extractor's handle on the store: entries at
    ``{root}/{family}/{key[:2]}/{key}.pkl``; its state is the filesystem
    and the fingerprints computed when it was built."""

    def __init__(self, root: str, family: str, config_fp: str,
                 weights_fp: str, *, fps: Optional[float] = None,
                 total: Optional[int] = None,
                 scope: str = "shared") -> None:
        self.root = str(root)
        self.family = str(family)
        self.config_fp = config_fp
        self.weights_fp = weights_fp
        self.scope = str(scope)
        self._fps = fps
        self._total = total

    @classmethod
    def for_extractor(cls, ext) -> Optional["FeatureCache"]:
        """The handle of a constructed extractor, or None under
        ``cache=false``; built after the subclass's init, so its resolved
        ``resize_mode``/``ingest`` and weights capture exist."""
        args = getattr(ext, "args", None)
        if args is None or not bool(args.get("cache", False)):
            return None
        root = args.get("cache_dir") or default_cache_dir()
        resolved = {}
        for attr, key in (("resize_mode", "resize"), ("ingest", "ingest")):
            val = getattr(ext, attr, None)
            if val is not None:
                resolved[key] = val
        device = getattr(ext, "device", None)
        if device is not None:
            resolved["device"] = getattr(device, "type", str(device))
        config_fp = config_fingerprint(args, resolved)
        weights_fp = weights_fingerprint(
            getattr(ext, "_weights_capture", None))
        return cls(os.path.join(root, str(ext.feature_type)),
                   ext.feature_type, config_fp, weights_fp,
                   fps=args.get("extraction_fps"),
                   total=args.get("extraction_total"),
                   scope=args.get("cache_scope", "shared") or "shared")

    def key_for(self, video_path: str) -> str:
        cid = content_identity(video_path, self._fps, self._total)
        if self.scope == "tenant":
            # a hit is only ever served to the tenant whose extraction
            # stored it; untenanted work keys under its own sentinel
            from .telemetry.context import current_tenant
            return entry_key(cid, self.config_fp, self.weights_fp,
                             tenant=current_tenant() or "_untenanted")
        return entry_key(cid, self.config_fp, self.weights_fp)

    def entry_path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".pkl")

    def lookup(self, video_path: str,
               expected_keys: Optional[Sequence[str]] = None
               ) -> Optional[Dict[str, np.ndarray]]:
        """The stored features of ``video_path``, or None (a miss). An
        entry that fails to load, has another schema or key set, or fails
        its signatures is deleted and reported as a miss. With
        ``trace=true`` the lookup is a ``cache.lookup`` span and a verified
        hit a ``cache.hit`` instant."""
        from .utils import inject

        with trace.span("cache.lookup", video=str(video_path),
                        family=self.family):
            key = self.key_for(video_path)
            path = self.entry_path(key)
            if not os.path.exists(path):
                return None
            try:
                fault = inject.fire("cache.lookup", video=str(video_path),
                                    key=key[:12])
                if fault is not None and fault.kind == "torn":
                    # a torn entry: verify-before-trust must catch it
                    with open(path, "r+b") as f:
                        f.truncate(max(1, os.path.getsize(path) // 2))
                with open(path, "rb") as f:
                    entry = pickle.load(f)
                feats = entry["feats"]
                sigs = entry["sigs"]
                if entry.get("schema") != SCHEMA_VERSION:
                    raise ValueError(
                        f"schema {entry.get('schema')!r} != "
                        f"{SCHEMA_VERSION}")
                if expected_keys is not None and \
                        set(feats) != set(expected_keys):
                    raise ValueError(
                        f"entry keys {sorted(feats)} != expected "
                        f"{sorted(expected_keys)}")
                for k, arr in feats.items():
                    if content_signature(np.asarray(arr)) != sigs.get(k):
                        raise ValueError(
                            f"content signature mismatch for key {k!r}")
            except Exception as e:
                print(f"cache: dropping corrupted entry {path} "
                      f"({type(e).__name__}: {e}) — treating as a miss")
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return None
            try:
                os.utime(path)  # the last verified hit, for eviction
            except OSError:
                pass
            trace.instant("cache.hit", video=str(video_path),
                          family=self.family, key=key[:12])
            return feats

    def store(self, video_path: str, feats: Dict[str, Any]) -> str:
        """Write one entry atomically with per-key content signatures;
        returns its key. With ``trace=true`` a ``cache.store`` span."""
        from .utils import inject
        from .utils.sinks import _write_bytes_atomic

        with trace.span("cache.store", video=str(video_path),
                        family=self.family):
            inject.fire("cache.store", video=str(video_path),
                        family=self.family)
            key = self.key_for(video_path)
            arrays = {k: np.asarray(v) for k, v in feats.items()}
            entry = {
                "schema": SCHEMA_VERSION,
                "family": self.family,
                "video": os.path.basename(str(video_path)),
                "config_fp": self.config_fp,
                "weights_fp": self.weights_fp,
                "sigs": {k: content_signature(a) for k, a in arrays.items()},
                "feats": arrays,
                "time": round(time.time(), 3),
            }
            _write_bytes_atomic(self.entry_path(key), pickle.dumps(entry))
            return key


def cache_stats(root: Optional[str] = None) -> Dict[str, Any]:
    """Entry count and bytes per family under ``root``."""
    root = root or default_cache_dir()
    out: Dict[str, Any] = {"root": root, "families": {}, "entries": 0,
                           "bytes": 0}
    if not os.path.isdir(root):
        return out
    for family in sorted(os.listdir(root)):
        fam_dir = os.path.join(root, family)
        if not os.path.isdir(fam_dir):
            continue
        n = b = 0
        for dirpath, _dirnames, filenames in os.walk(fam_dir):
            for fn in filenames:
                if fn.endswith(".pkl"):
                    n += 1
                    try:
                        b += os.path.getsize(os.path.join(dirpath, fn))
                    except OSError:
                        pass
        out["families"][family] = {"entries": n, "bytes": b}
        out["entries"] += n
        out["bytes"] += b
    return out
