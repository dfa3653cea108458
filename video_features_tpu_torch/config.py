"""Config system: per-feature YAML defaults + CLI dotlist overrides.

The port's own copy of ``video_features_tpu/config.py`` (``Config``,
``parse_dotlist``, ``merge``, ``load_config``) with a ``sanity_check`` cut to
the keys the ported families (``registry.py``) run. ``yaml`` is imported
only where YAML is parsed, so importing the extractors needs no ``yaml``.

Every port YAML carries every key of its JAX twin at the JAX default. A key
whose plane the port does not run yet is accepted at its default only; any
other value raises ``NotImplementedError`` naming the ``ROADMAP.md`` Queue 1
item that will port it (:data:`GATED_KEYS`), instead of being ignored.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from .device import precision_dtype, resolve_device

_CONFIG_DIR = Path(__file__).resolve().parent / "configs"

#: key -> (the values the port accepts, the ROADMAP.md Queue 1 item that
#: ports the key's plane; None for ``config``, which the JAX package reads
#: at no value either)
GATED_KEYS = {
    # batching and multi-GPU data parallelism (#6)
    "distributed": ((None, False), 6),
    "mesh_devices": ((None,), 6),
    "video_workers": ((None, 1), 6),
    "cross_video_batching": ((None, False), 6),
    # CLIP's tensor parallelism over a (data, model) mesh (#6)
    "model_parallel": ((None, 1), 6),
    # multi-family CLI and the feature cache (#7)
    "cache": ((None, False), 7),
    "cache_dir": ((None,), 7),
    "cache_scope": ((None, "shared"), 7),
    # warm serving, compile caches and the fleet (#8)
    "compile_cache": ((None, "auto", False), 8),
    "compile_cache_dir": ((None,), 8),
    "compilation_cache_dir": ((None, "auto"), 8),
    "fleet": ((None, "static"), 8),
    "fleet_lease_s": ((None, 60), 8),
    "fleet_max_reclaims": ((None, 3), 8),
    "fleet_canary": ((None, False), 8),
    "serve_slo_s": ((None,), 8),
    # device-facing telemetry (#9)
    "telemetry": ((None, False), 9),
    "trace": ((None, False), 9),
    "health": ((None, False), 9),
    "parity": ((None, False), 9),
    "roofline": ((None, False), 9),
    "history": ((None, False), 9),
    "alerts": ((None, False), 9),
    "metrics_interval_s": ((None, 30), 9),
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


def video_list(video_paths: Union[str, Sequence[str], None] = None,
               file_with_video_paths: Optional[str] = None) -> List[str]:
    """Inline str/list of paths, or a text file with one path per line
    (blank lines skipped); missing paths warn, they do not raise."""
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
