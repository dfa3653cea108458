"""Config system: per-feature YAML defaults + CLI dotlist overrides.

The port's own copy of ``video_features_tpu/config.py`` (``Config``,
``parse_dotlist``, ``merge``, ``load_config``, and for a multi-family run
``load_multi_config`` and ``sanity_check_multi``) with a ``sanity_check``
cut to the keys the ported families (``registry.py``) run. ``yaml`` is imported
only where YAML is parsed, so importing the extractors needs no ``yaml``.

Every port YAML carries every key of its JAX twin at the JAX default. A key
whose plane the port does not run yet is accepted at its default only; any
other value raises ``NotImplementedError`` naming the ``ROADMAP.md`` Queue 1
item that will port it (:data:`GATED_KEYS`), instead of being ignored.
"""
from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from .device import precision_dtype, resolve_device

_CONFIG_DIR = Path(__file__).resolve().parent / "configs"

#: validated config keys that appear in only SOME family YAMLs
#: (family-specific defaults). vft-lint's VFT002 (``lint/rules.py``) wants
#: every key a validator reads carried by ALL the family YAMLs unless it is
#: declared here or in LAUNCH_KEYS. The JAX package's set.
OPTIONAL_KEYS = frozenset({
    "batch_size", "bpe_path", "clip_batch_size", "corr_lookup_impl",
    "extraction_fps", "extraction_total", "finetuned_on", "flow_iters",
    "flow_model_weights_path", "flow_stack_batch", "flow_type",
    "flow_weights_path", "fps_mode", "frontend", "fuse_convc1", "ingest",
    "iters", "model_name", "model_parallel", "pca_weights_path",
    "postprocess", "pred_texts", "resize", "resize_to_smaller_edge",
    "side_size", "stack_size", "step_size", "streams", "vision_attn",
})

#: launch-time keys that never ride a family YAML: the serve and gateway
#: command lines' spool plumbing, the storage keys, and expert decode
#: knobs that are deliberately undocumented defaults (the JAX package's
#: set), so VFT002 tells "launch-only by design" from a typo'd key.
LAUNCH_KEYS = frozenset({
    # profiling hooks (cli.py)
    "profile", "profile_trace_dir",
    # expert decode-pipeline knobs (extractors/base.py, multi.py)
    "video_decode", "decode_workers", "decode_depth", "fanout_depth",
    "cross_video_batching",
    # serve launch keys (serve.py; serve_slo_s rides the YAMLs)
    "spool_dir", "serve_max_pending", "serve_poll_interval_s",
    "serve_idle_exit_s", "serve_max_requests", "serve_workers",
    "serve_warmup_video",
    # gateway launch keys (gateway.py validate_gateway_args)
    "gateway_tenants", "gateway_port", "gateway_host",
    "gateway_max_queued", "gateway_spool_bound", "gateway_max_body_mb",
    "gateway_poll_interval_s", "gateway_expire_grace_s",
    "gateway_default_timeout_s",
    # gc launch keys (gc.py validate_gc_args)
    "gc", "gc_quota_gb", "gc_cache_retention_s",
    "gc_compile_retention_s", "gc_spool_retention_s",
    "gc_inbox_retention_s", "gc_incident_retention_s",
    "gc_quarantine_retention_s", "gc_staging_retention_s",
    "gc_interval_s",
})

#: removed reference flags: accepted, warned about and deleted by
#: :func:`sanity_check`, exempt from every other key contract.
REMOVED_KEYS = frozenset({"device_ids"})

#: key -> (the values the port accepts, the ROADMAP.md Queue 1 item that
#: ports the key's plane; None for ``config``, which the JAX package reads
#: at no value either)
GATED_KEYS = {
    "config": ((None,), None),
}
#: families with a ``show_pred`` (``vggish`` has none in either package:
#: its extractor raises)
SHOW_PRED_FAMILIES = ("i3d", "raft", "pwc", "r21d", "s3d", "resnet", "clip")
#: the decode sources of ``video_decode`` (``utils/io.py``)
VIDEO_DECODE_MODES = ("inline", "process", "parallel")


class Config(dict):
    """A dict with attribute access, nesting-aware."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            super().__setitem__(k, Config._wrap(v))

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))


def build_cfg_path(feature_type: str) -> Path:
    return _CONFIG_DIR / f"{feature_type}.yml"


def load_yaml(path: Union[str, os.PathLike]) -> Config:
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config(data)


def parse_dotlist(argv: Sequence[str]) -> Config:
    """Parse ``key=value`` CLI arguments. Values go through YAML, so
    ``batch_size=16`` is an int and ``flow_type=null`` is None; dots nest."""
    import yaml
    out: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(
                f"CLI arguments must look like key=value (got {arg!r})")
        key, raw = arg.split("=", 1)
        try:
            value = yaml.safe_load(raw) if raw != "" else None
        except yaml.YAMLError:
            value = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return Config(out)


def merge(base: Config, override: Config) -> Config:
    """Deep merge; ``override`` wins."""
    result = Config(dict(base))
    for k, v in override.items():
        if k in result and isinstance(result[k], dict) and isinstance(v, dict):
            result[k] = merge(result[k], v)
        else:
            result[k] = v
    return result


def load_config(feature_type: str,
                overrides: Optional[Union[Config, Dict[str, Any]]] = None,
                ) -> Config:
    """YAML defaults for ``feature_type`` merged under ``overrides``."""
    cfg_path = build_cfg_path(feature_type)
    if not cfg_path.exists():
        raise FileNotFoundError(
            f"Unknown feature_type {feature_type!r}: no config at {cfg_path}")
    cfg = load_yaml(cfg_path)
    if overrides:
        cfg = merge(cfg, Config(dict(overrides)))
    return cfg


def load_multi_config(families: Sequence[str],
                      overrides: Optional[Union[Config, Dict[str, Any]]] = None,
                      ) -> Dict[str, Config]:
    """Per-family configs of a multi-family run, in the order of
    ``families``. Top-level keys are shared (merged into every family's
    YAML defaults); a key nested under a requested family's name is that
    family's own and wins: ``feature_type=resnet,clip extraction_fps=1
    clip.extraction_fps=2`` runs resnet at 1 fps and clip at 2. An override
    block of a known family that is not requested raises, as in JAX."""
    from .registry import _DISPATCH
    families = list(families)
    overrides = Config(dict(overrides or {}))
    shared = {k: v for k, v in overrides.items()
              if k != "feature_type" and k not in families}
    for k in list(shared):
        if k in _DISPATCH and isinstance(shared[k], dict):
            raise ValueError(
                f"per-family override block {k}.* given, but {k!r} is not "
                f"in feature_type={','.join(families)} — add it to the "
                "list or drop the override")
    per: Dict[str, Config] = {}
    for f in families:
        fam_over = overrides.get(f)
        merged = Config(dict(shared))
        if isinstance(fam_over, dict):
            merged = merge(merged, Config(dict(fam_over)))
        cfg = load_config(f, merged)
        cfg.feature_type = f
        per[f] = cfg
    return per


def sanity_check_multi(per_family: Dict[str, Config], *,
                       require_videos: bool = True) -> None:
    """The multi-family constraints (a file sink, no ``show_pred``, no
    ``fps_mode=reencode``), then each family's :func:`sanity_check`, which
    namespaces its ``output_path``/``tmp_path`` under its own
    ``feature_type[/model_name]``, so sinks and journals never collide."""
    for args in per_family.values():
        if args.get("on_extraction", "print") == "print":
            raise ValueError(
                "multi-family extraction needs a file sink "
                "(on_extraction=save_numpy or save_pickle): N families' "
                "print dumps would interleave, and the per-family skip/"
                "journal contracts need per-family output dirs")
        if args.get("show_pred"):
            raise ValueError(
                "show_pred=true is unsupported in multi-family runs "
                "(per-batch prediction printing would interleave across "
                "families)")
        if (args.get("fps_mode", "select") or "select") == "reencode":
            raise ValueError(
                "fps_mode=reencode is unsupported in multi-family runs: "
                "each family's reencode provenance is its own lossy "
                "temp-file decode, which cannot share one pass — run "
                "golden-parity extractions one family at a time")
        sanity_check(args, require_videos=require_videos)


def video_list(video_paths: Union[str, Sequence[str], None] = None,
               file_with_video_paths: Optional[str] = None,
               shuffle: bool = False) -> List[str]:
    """Inline str/list of paths, or a text file with one path per line
    (blank lines skipped); missing paths warn, they do not raise.
    ``shuffle`` shuffles the list (``random.shuffle``), as the JAX CLI does
    so that independently launched workers start on different videos."""
    if file_with_video_paths is not None:
        with open(file_with_video_paths) as f:
            paths = [line.strip("\n") for line in f if line.strip("\n")]
    elif video_paths is None:
        paths = []
    elif isinstance(video_paths, str):
        paths = [video_paths]
    else:
        paths = [str(p) for p in video_paths]
    for path in paths:
        if not Path(path).exists():
            print(f"The path does not exist: {path}")
    if shuffle:
        random.shuffle(paths)
    return paths


def _roadmap(item: Optional[int]) -> str:
    return "ROADMAP.md Queue 1" + (f" #{item}" if item else "")


def check_ported(args: Config) -> None:
    """Raise ``NotImplementedError`` for a value the port does not run yet:
    a :data:`GATED_KEYS` key away from its default, and
    ``precision=bfloat16`` outside ``device.BF16_FAMILIES``; and, as
    the JAX package does, for a ``video_decode`` outside
    :data:`VIDEO_DECODE_MODES`. ``show_pred`` passes: every family of
    :data:`SHOW_PRED_FAMILIES` runs it, and vggish's extractor raises, as
    JAX's does."""
    for key, (accepted, item) in GATED_KEYS.items():
        value = args.get(key)
        if value not in accepted:
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet ({_roadmap(item)}); "
                f"the port accepts {' or '.join(map(repr, accepted))}")
    feature_type = args.get("feature_type")
    precision_dtype(args.get("precision"), feature_type)
    decode = args.get("video_decode") or "inline"
    if decode not in VIDEO_DECODE_MODES:
        raise NotImplementedError(
            f"video_decode={decode!r}: expected 'inline', 'process' or "
            "'parallel'")


def _check_telemetry(args: Config) -> None:
    """``telemetry``, ``trace``, ``health``, ``parity``, ``roofline``,
    ``history`` and ``alerts`` (true or false; ``history`` and ``alerts``
    need ``telemetry=true``) and ``metrics_interval_s`` (> 0), as the JAX
    package checks them."""
    for key, what in (("telemetry", "writes {output_path}/_telemetry.jsonl, "
                       "_run.json and heartbeats, telemetry/"),
                      ("trace", "writes {output_path}/_trace.json, "
                       "telemetry/trace.py"),
                      ("health", "digests features into {output_path}/"
                       "_health.jsonl and quarantines NaN/Inf outputs, "
                       "telemetry/health.py"),
                      ("parity", "per-seam numerics digests into "
                       "{output_path}/_parity.jsonl, telemetry/parity.py"),
                      ("roofline", "MFU accounting into {output_path}/"
                       "_roofline.json, telemetry/roofline.py"),
                      ("history", "retained heartbeat samples in "
                       "{output_path}/_history_{host_id}.jsonl, "
                       "telemetry/history.py"),
                      ("alerts", "alert rules on the heartbeat cadence into "
                       "{output_path}/_alerts.jsonl + _incidents/ bundles, "
                       "telemetry/alerts.py — render with python -m "
                       "video_features_tpu_torch.telemetry.alerts")):
        value = args.get(key, False)
        if not isinstance(value, bool):
            raise ValueError(f"{key}={value!r}: expected true or false "
                             f"({what})")
    if (args.get("history", False) or args.get("alerts", False)) \
            and not args.get("telemetry", False):
        raise ValueError(
            "history=true / alerts=true need telemetry=true: samples and "
            "rule evaluation ride the heartbeat cadence")
    mi = args.get("metrics_interval_s")
    if mi is not None and float(mi) <= 0:
        raise ValueError(f"metrics_interval_s={mi!r}: need a float > 0 "
                         "(the heartbeat/metrics flush period)")


def _check_vggish(args: Config) -> None:
    """``frontend``, ``postprocess`` and ``pca_weights_path``."""
    frontend = args.get("frontend")
    if frontend is not None and frontend not in ("host", "device"):
        raise NotImplementedError(f"frontend={frontend!r}: expected 'host' "
                                  "or 'device'")
    post = args.get("postprocess")
    if post is not None and not isinstance(post, bool):
        raise ValueError(f"postprocess={post!r}: expected true or false")
    if post:
        pca_weights_path(args)


def _check_cache(args: Config) -> None:
    """``cache`` (a boolean), ``cache_dir`` (a path or null) and
    ``cache_scope`` (``shared`` or ``tenant``), as the JAX package checks
    them."""
    ca = args.get("cache", False)
    if not isinstance(ca, bool):
        raise ValueError(f"cache={ca!r}: expected true or false (the "
                         "content-addressed feature cache, cache.py)")
    cd = args.get("cache_dir")
    if cd is not None and not isinstance(cd, str):
        raise ValueError(f"cache_dir={cd!r}: expected a directory path or "
                         "null (null -> VFT_CACHE_DIR or "
                         "~/.cache/video_features_tpu/feature_cache)")
    cs = args.get("cache_scope", "shared") or "shared"
    if cs not in ("shared", "tenant"):
        raise ValueError(f"cache_scope={cs!r}: expected 'shared' (one "
                         "entry per content) or 'tenant' (the requesting "
                         "tenant salts the key)")


def _check_gc(args: Config) -> None:
    """Every ``gc``/``gc_*`` key, whether or not ``gc=true``, through
    ``gc.py validate_gc_args``, as the JAX package checks them: the run
    and the ``gc`` command fail a typo alike."""
    if "gc" in args or any(str(k).startswith("gc_") for k in args):
        from .gc import validate_gc_args
        validate_gc_args(args)


def _check_serving(args: Config) -> None:
    """The keys of the serving plane, as the JAX package checks them: the
    ``gateway_*`` keys (``gateway.py validate_gateway_args``), the compile
    cache (``compile_cache`` true, false or ``auto``; ``compile_cache_dir``
    and ``compilation_cache_dir`` paths or null), the fleet queue
    (``fleet`` ``static`` or ``queue``, which needs ``telemetry=true`` and a
    file sink; ``fleet_lease_s`` > 0; ``fleet_max_reclaims`` >= 1;
    ``fleet_canary`` a boolean) and ``serve_slo_s`` (> 0 or null)."""
    if any(str(k).startswith("gateway_") for k in args):
        from .gateway import validate_gateway_args
        validate_gateway_args(args)
    cc = args.get("compile_cache", "auto")
    if cc not in (True, False, "auto", None):
        raise ValueError(f"compile_cache={cc!r}: expected true, false or "
                         "'auto' ('auto' = on for cuda runs; CPU runs need "
                         "an explicit compile_cache_dir)")
    for key in ("compile_cache_dir", "compilation_cache_dir"):
        d = args.get(key)
        if d is not None and not isinstance(d, str):
            raise ValueError(f"{key}={d!r}: expected a directory path or "
                             "null")
    fl = args.get("fleet", "static") or "static"
    if fl not in ("static", "queue"):
        raise ValueError(f"fleet={fl!r}: expected 'static' (md5 hash "
                         "sharding fixed at launch) or 'queue' (the "
                         "work-stealing lease queue, parallel/queue.py)")
    if fl == "queue":
        if not args.get("telemetry", False):
            raise ValueError(
                "fleet=queue needs telemetry=true: the heartbeat thread "
                "renews work-item leases and heartbeats are the fleet "
                "membership and liveness signal")
        if args.get("on_extraction", "print") == "print":
            raise ValueError(
                "fleet=queue needs a file sink (on_extraction=save_numpy "
                "or save_pickle): stolen work relies on the idempotent "
                "skip-if-exists output contract, which print lacks")
    fls = args.get("fleet_lease_s")
    if fls is not None and float(fls) <= 0:
        raise ValueError(f"fleet_lease_s={fls!r}: need a float > 0 (the "
                         "work-item lease period; renewed every heartbeat)")
    fmr = args.get("fleet_max_reclaims")
    if fmr is not None and int(fmr) < 1:
        raise ValueError(f"fleet_max_reclaims={fmr!r}: need an int >= 1 "
                         "(reclaims before an item is quarantined)")
    fca = args.get("fleet_canary", False)
    if not isinstance(fca, bool):
        raise ValueError(f"fleet_canary={fca!r}: expected true or false "
                         "(gate joining hosts on a re-extracted slice)")
    slo = args.get("serve_slo_s")
    if slo is not None:
        try:
            slo_f = float(slo)
        except (TypeError, ValueError):
            slo_f = 0.0
        if slo_f <= 0:
            raise ValueError(f"serve_slo_s={slo!r}: need a float > 0 in "
                             "seconds, or null to disable violation "
                             "counting")


def _check_parallel(args: Config) -> None:
    """``video_workers`` (an int >= 1 or ``auto``; forced to 1, with the
    JAX package's warning, where concurrent videos would interleave their
    stdout), ``mesh_devices`` and ``model_parallel`` (ints >= 1 or null),
    ``distributed`` and ``cross_video_batching`` (booleans)."""
    vw = args.get("video_workers") or 1
    if isinstance(vw, str):
        vw = vw.strip().lower()
        if vw != "auto":
            raise ValueError(f"video_workers={vw!r}: expected an int or "
                             "'auto'")
        args.video_workers = vw
    elif isinstance(vw, bool) or not isinstance(vw, int) or vw < 1:
        raise ValueError(f"video_workers={vw!r}: expected an int >= 1 or "
                         "'auto'")
    if (vw == "auto" or vw > 1) and (
            args.get("on_extraction", "print") == "print"
            or args.get("show_pred")):
        print("WARNING: video_workers > 1 with on_extraction=print or "
              "show_pred would interleave per-video output; forcing "
              "video_workers=1. Use save_numpy/save_pickle for pipelined "
              "multi-video extraction.")
        args.video_workers = 1
    for key in ("mesh_devices", "model_parallel"):
        v = args.get(key)
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)
                              or v < 1):
            raise ValueError(f"{key}={v!r}: expected an int >= 1 or null")
    for key in ("distributed", "cross_video_batching"):
        v = args.get(key)
        if v is not None and not isinstance(v, bool):
            raise ValueError(f"{key}={v!r}: expected true or false")


def pca_weights_path(args: Config) -> str:
    """The PCA params that ``postprocess=true`` needs: ``pca_weights_path``,
    else the ``vggish_pca`` files the weights store finds
    (``weights/store.py find_checkpoint``); ``FileNotFoundError`` naming
    the key and the store's directory where there are none."""
    from .weights import store
    pca = args.get("pca_weights_path")
    if pca and not Path(str(pca)).exists():
        raise FileNotFoundError(f"pca_weights_path does not exist: {pca}")
    found = store.find_checkpoint("vggish_pca", pca)
    if found is None:
        raise FileNotFoundError(
            "postprocess=true needs the PCA params; drop "
            "vggish_pca_params-970ea276.pth (or the .npz twin) into "
            f"{store.weights_dir()} or pass pca_weights_path=...")
    return str(found)


def sanity_check(args: Config, *, require_videos: bool = True) -> None:
    """Validate user arguments and patch output/tmp paths in place.

    The subset of ``video_features_tpu.config.sanity_check`` the ported
    families need: video list, unique stems, out != tmp, i3d
    ``stack_size >= 10``, ``extraction_fps``/``extraction_total`` exclusive,
    ``resize``, ``corr_lookup_impl``/``fuse_convc1``, the flow families'
    keys ``iters``, ``batch_size``, ``side_size`` and
    ``resize_to_smaller_edge`` (``ExtractRAFT`` checks ``finetuned_on``),
    ``fps_mode``,
    the clip-stack and frame-wise families' ``model_name`` and ``ingest``,
    vggish's ``frontend``, ``postprocess`` and ``pca_weights_path``, the
    retry, deadline and ``inject`` keys,
    the parallel keys (``video_workers``, forced to 1 for ``print`` and
    ``show_pred`` runs as in the JAX package, ``mesh_devices``,
    ``model_parallel``, ``distributed``, ``cross_video_batching``), the
    cache keys (``cache``, ``cache_dir``, ``cache_scope``), the telemetry
    keys (``telemetry``, ``metrics_interval_s``, ``trace``, ``health``,
    ``parity``, ``roofline``, ``history``, ``alerts``), the serving keys
    (the compile cache, the fleet queue, ``serve_slo_s``, ``gateway_*``),
    the storage keys (``gc``, ``gc_*``), the unported keys, the removed
    ``device_ids`` (warned about and deleted), the device
    (``args.device`` becomes ``cpu``, ``cuda`` or ``cuda:N``) and the
    ``feature_type[/model_name]`` namespacing of
    ``output_path``/``tmp_path``."""
    check_ported(args)
    if "device_ids" in args:
        print("WARNING: `device_ids` is a removed reference flag; the data "
              "mesh spans the cards of `device` (and `mesh_devices`). "
              "Ignoring it.")
        del args["device_ids"]
    args.device = str(resolve_device(args.get("device")))
    if args.feature_type in ("r21d", "s3d", "resnet", "clip"):
        from .registry import get_extractor_cls
        cls = get_extractor_cls(args.feature_type)
        names = None
        if args.feature_type == "r21d":
            from .models.r21d import VARIANTS as names
        elif args.feature_type == "resnet":
            from .models.resnet import VARIANTS as names
        elif args.feature_type == "clip":
            from .models.clip import CONFIGS
            names = list(CONFIGS) + ["custom"]
        if names is not None and args.get("model_name") not in names:
            raise NotImplementedError(
                f"Model {args.get('model_name')} not found; expected one of "
                f"{sorted(names)}")
        ingest = args.get("ingest")
        if ingest is not None and ingest not in cls.supported_ingest:
            raise NotImplementedError(
                f"ingest={ingest!r}; {cls.__name__} supports "
                f"{cls.supported_ingest}")
    ra = args.get("retry_attempts")
    if ra is not None and int(ra) < 1:
        raise ValueError(f"retry_attempts={ra!r}: need an int >= 1")
    rb = args.get("retry_backoff_s")
    if rb is not None and float(rb) < 0:
        raise ValueError(f"retry_backoff_s={rb!r}: need a float >= 0")
    vd = args.get("video_deadline_s")
    if vd is not None and float(vd) <= 0:
        raise ValueError(f"video_deadline_s={vd!r}: need a float > 0 "
                         "(or null to disable the per-video deadline)")
    inj = args.get("inject")
    if inj is not None:
        if not isinstance(inj, str):
            raise ValueError(f"inject={inj!r}: expected a plan string like "
                             "'seed=1;sink.fsync=enospc@n1' or null")
        from .utils.inject import parse_plan
        parse_plan(inj)  # raises naming the bad clause or unported site
    if args.feature_type == "vggish":
        _check_vggish(args)
    _check_parallel(args)
    _check_cache(args)
    _check_telemetry(args)
    _check_serving(args)
    _check_gc(args)

    if require_videos:
        if not (args.get("file_with_video_paths") or args.get("video_paths")):
            raise ValueError(
                "`video_paths` or `file_with_video_paths` must be specified")
        stems = [Path(p).stem for p in video_list(
            args.get("video_paths"), args.get("file_with_video_paths"))]
        if len(stems) != len(set(stems)):
            raise ValueError("Non-unique video file stems: outputs would "
                             "overwrite each other")
    if os.path.relpath(str(args.output_path)) == \
            os.path.relpath(str(args.tmp_path)):
        raise ValueError("The same path for out & tmp")
    if args.feature_type == "i3d" and args.get("stack_size") is not None \
            and int(args.stack_size) < 10:
        raise ValueError("I3D model does not support inputs shorter than 10 "
                         f"timestamps. You have: {args.stack_size}")
    if args.get("extraction_fps") is not None \
            and args.get("extraction_total") is not None:
        raise ValueError(
            "`extraction_fps` and `extraction_total` are mutually exclusive")
    rz = args.get("resize")
    if rz is not None and rz not in ("auto", "host", "device"):
        raise ValueError(f"resize={rz!r}: expected 'auto', 'host' or "
                         "'device'")
    impl = args.get("corr_lookup_impl")
    if impl is not None and impl not in ("gather", "onehot", "pallas",
                                         "packed"):
        raise ValueError(f"corr_lookup_impl={impl!r}: expected null "
                         "(the CUDA kernels), 'pallas' (the same), 'packed' "
                         "(the packed kernel), 'gather' or 'onehot'")
    fc1 = args.get("fuse_convc1")
    if fc1 is not None and not isinstance(fc1, bool):
        raise ValueError(f"fuse_convc1={fc1!r}: expected true, false or "
                         "null")
    if "batch_size" in args and args.batch_size is None:
        raise ValueError("Please specify `batch_size`. It is None now")
    for key in ("batch_size", "iters", "side_size"):
        v = args.get(key)
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)
                              or v < 1):
            raise ValueError(f"{key}={v!r}: expected an int >= 1")
    rse = args.get("resize_to_smaller_edge")
    if rse is not None and not isinstance(rse, bool):
        raise ValueError(f"resize_to_smaller_edge={rse!r}: expected true or "
                         "false")
    fps_mode = args.get("fps_mode", "select") or "select"
    if fps_mode not in ("select", "reencode"):
        raise ValueError(
            f"fps_mode={fps_mode!r}: expected 'select' (bit-exact source "
            "frames, the default) or 'reencode' (the reference's lossy "
            "temp-file decode path, for golden-parity runs)")

    subs: List[str] = [args.feature_type]
    if args.get("model_name") is not None:
        subs.append(str(args.model_name))
    out, tmp = str(args.output_path), str(args.tmp_path)
    for p in subs:
        out = os.path.join(out, p.replace("/", "_"))
        tmp = os.path.join(tmp, p.replace("/", "_"))
    args.output_path = out
    args.tmp_path = tmp
