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

#: key -> (the values the port accepts, the ROADMAP.md Queue 1 item that
#: ports the key's plane; None for ``config``, which the JAX package reads
#: at no value either)
GATED_KEYS = {
    # warm serving, compile caches and the fleet (#8)
    "compile_cache": ((None, "auto", False), 8),
    "compile_cache_dir": ((None,), 8),
    "compilation_cache_dir": ((None, "auto"), 8),
    "fleet": ((None, "static"), 8),
    "fleet_lease_s": ((None, 60), 8),
    "fleet_max_reclaims": ((None, 3), 8),
    "fleet_canary": ((None, False), 8),
    "serve_slo_s": ((None,), 8),
    # CLIP's blockwise vision attention, parallel/sequence.py (#10)
    "vision_attn": ((None, "dense"), 10),
    "config": ((None,), None),
}
#: families whose ``show_pred`` is ported (``vggish`` has none in either
#: package: its extractor raises)
SHOW_PRED_FAMILIES = ("r21d", "s3d", "resnet", "clip")
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
    a :data:`GATED_KEYS` key away from its default, ``show_pred`` outside
    :data:`SHOW_PRED_FAMILIES`, ``fps_mode=reencode``, and
    ``precision=bfloat16`` outside ``device.BF16_FAMILIES``; and, as the JAX
    package does, for a ``video_decode`` outside
    :data:`VIDEO_DECODE_MODES`."""
    for key, (accepted, item) in GATED_KEYS.items():
        value = args.get(key)
        if value not in accepted:
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet ({_roadmap(item)}); "
                f"the port accepts {' or '.join(map(repr, accepted))}")
    feature_type = args.get("feature_type")
    if args.get("show_pred") and feature_type not in SHOW_PRED_FAMILIES \
            and feature_type != "vggish":
        raise NotImplementedError(
            f"show_pred=true is not ported yet for feature_type="
            f"{feature_type!r} ({_roadmap(None)}); it is for "
            f"{', '.join(SHOW_PRED_FAMILIES)}")
    precision_dtype(args.get("precision"), feature_type)
    decode = args.get("video_decode") or "inline"
    if decode not in VIDEO_DECODE_MODES:
        raise NotImplementedError(
            f"video_decode={decode!r}: expected 'inline', 'process' or "
            "'parallel'")
    if (args.get("fps_mode") or "select") == "reencode":
        raise NotImplementedError(
            "fps_mode='reencode' is not ported yet (it needs an ffmpeg "
            f"binary; {_roadmap(11)})")


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
    """``pca_weights_path``, which ``postprocess=true`` needs;
    ``FileNotFoundError`` naming the key when it is unset or missing (the
    port has no weights directory to search, ROADMAP.md Queue 1 #12)."""
    pca = args.get("pca_weights_path")
    if not pca or not Path(str(pca)).exists():
        raise FileNotFoundError(
            "postprocess=true needs the PCA params: pass pca_weights_path= "
            f"a vggish_pca_params .pth or .npz (got {pca!r})")
    return str(pca)


def sanity_check(args: Config, *, require_videos: bool = True) -> None:
    """Validate user arguments and patch output/tmp paths in place.

    The subset of ``video_features_tpu.config.sanity_check`` the ported
    families need: video list, unique stems, out != tmp, i3d
    ``stack_size >= 10``, ``extraction_fps``/``extraction_total`` exclusive,
    ``resize``, ``corr_lookup_impl``/``fuse_convc1``, the flow families'
    keys ``iters``, ``batch_size``, ``side_size`` and
    ``resize_to_smaller_edge`` (``ExtractRAFT`` checks ``finetuned_on``),
    the clip-stack and frame-wise families' ``model_name`` and ``ingest``,
    vggish's ``frontend``, ``postprocess`` and ``pca_weights_path``, the
    retry, deadline and ``inject`` keys,
    the parallel keys (``video_workers``, forced to 1 for ``print`` and
    ``show_pred`` runs as in the JAX package, ``mesh_devices``,
    ``model_parallel``, ``distributed``, ``cross_video_batching``), the
    cache keys (``cache``, ``cache_dir``, ``cache_scope``), the telemetry
    keys (``telemetry``, ``metrics_interval_s``, ``trace``, ``health``,
    ``parity``, ``roofline``, ``history``, ``alerts``),
    the unported keys, the device (``args.device`` becomes ``cpu``,
    ``cuda`` or ``cuda:N``) and the ``feature_type[/model_name]``
    namespacing of ``output_path``/``tmp_path``."""
    check_ported(args)
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

    subs: List[str] = [args.feature_type]
    if args.get("model_name") is not None:
        subs.append(str(args.model_name))
    out, tmp = str(args.output_path), str(args.tmp_path)
    for p in subs:
        out = os.path.join(out, p.replace("/", "_"))
        tmp = os.path.join(tmp, p.replace("/", "_"))
    args.output_path = out
    args.tmp_path = tmp
