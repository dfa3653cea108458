"""Fleet-shared kernel compile cache: never compile twice, anywhere (port of
``video_features_tpu/compile_cache.py``).

The port compiles one thing: the ``nvcc`` build of ``kernels/csrc/*.cu``
into one shared library (``kernels/build.py``). Without this module each
machine builds it into its own ``kernels/_build/`` (or
``compilation_cache_dir``), and a joining host pays ``nvcc`` before its
first claim. This module gives that build the feature cache's discipline,
as the JAX package gives its XLA executables:

  **entry** = one directory per ``(family, config fingerprint,
  environment fingerprint)`` triple at ``{root}/{family}/{key[:2]}/{key}/``,
  where

    - the **config fingerprint** is ``cache.py config_fingerprint`` over the
      config with :func:`resolved_overlay` (``resize=auto`` keys as its
      resolution), so two configs that run the same programs share an entry;
    - the **environment fingerprint** covers the torch version,
      ``torch.version.cuda``, the ``nvcc`` release, the driver version and
      the card's name and compute capability: a toolkit bump or another
      card resolves to a different entry, never to a wrong hit.

  The entry holds the library (``libvft_kernels_<digest>.so``, the digest
  of the sources and flags) and its ``-Xptxas -v`` report.

  **verify-before-trust**: :meth:`CompileCacheEntry.seal` (when a run
  exits) records every file's sha256 in ``_sums.json`` and writes the
  ``_entry.json`` manifest, both atomically. :func:`attach` re-hashes on
  the way in: a file whose sum mismatches (bit rot, tampering) or that was
  never sealed (its writer died) is deleted and the build counts a miss,
  so a corrupt library is never loaded.

  **warm promise**: an entry whose manifest exists and whose sealed files
  (the library of the current sources among them) all verify is *warm*: a
  joining host builds nothing (the fleet canary's warm fast path,
  ``parallel/queue.py``). A family whose path runs no kernel gets an entry
  with a manifest and no files, which is trivially warm.
  ``python -m video_features_tpu_torch warmup <family> ...`` builds and
  seals an entry ahead of time.

``compile_cache=auto`` (the YAML default) is on for ``cuda`` runs and off
on the CPU, where ``compile_cache_dir`` (or ``compile_cache=true``) turns
it on. The attach is process-global and first-wins (one kernel library per
process: ``kernels/build.load`` is cached); a multi-family run attaches one
combined entry. ``kernels/build.py`` takes the library from the attached
entry or builds into it, and counts a hit (loaded from the store, no
``nvcc``) or a miss (``nvcc`` ran); the counts reach every heartbeat's and
the manifest's ``compile_cache`` section (``telemetry/recorder.py``).
The port uses no ``torch.compile``, so nothing else is cached.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: schema identifier stamped into every entry manifest
SCHEMA_VERSION = "vft.compile_cache/1"

#: per-entry metadata files
MANIFEST_NAME = "_entry.json"
SUMS_NAME = "_sums.json"

#: the cached artifacts: the kernel library and its ptxas report
_LIB_SUFFIX = ".so"
_REPORT_SUFFIX = ".ptxas.txt"


def _safe(name: str) -> str:
    """Filesystem-safe directory component (multi-family entries embed
    comma-joined family lists)."""
    return re.sub(r"[^A-Za-z0-9._,-]+", "-", str(name))


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def default_root() -> str:
    return os.environ.get(
        "VFT_COMPILE_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "video_features_tpu", "compile_cache"))


# -- fingerprints -------------------------------------------------------------

def _run_text(cmd: List[str]) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=30)
        return proc.stdout if proc.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def nvcc_release() -> str:
    """``nvcc --version``'s release (``12.4``), ``?`` without a toolkit."""
    from .kernels import build
    try:
        nvcc = build.nvcc_path()
    except RuntimeError:
        return "?"
    m = re.search(r"release ([0-9.]+)", _run_text([nvcc, "--version"]))
    return m.group(1) if m else "?"


def driver_version() -> str:
    """The NVIDIA driver's version off ``nvidia-smi``, ``?`` without one."""
    out = _run_text(["nvidia-smi", "--query-gpu=driver_version",
                     "--format=csv,noheader"]).strip().splitlines()
    return out[0].strip() if out else "?"


def env_fingerprint(torch_version: Optional[str] = None,
                    cuda_version: Optional[str] = None,
                    nvcc: Optional[str] = None,
                    driver: Optional[str] = None,
                    device_name: Optional[str] = None,
                    capability: Optional[str] = None,
                    ) -> Tuple[Dict[str, Any], str]:
    """The toolchain and card a built library depends on, as ``(components
    dict, sha256 hex)``. Every component is overridable so tests can pin
    "what if the toolkit bumped": a changed component changes the
    fingerprint, which resolves to another entry directory (the
    miss-on-version-change contract)."""
    import torch
    if device_name is None or capability is None:
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            device_name = device_name or torch.cuda.get_device_name(0)
            capability = capability or f"sm_{major}{minor}"
        else:
            device_name = device_name or "cpu"
            capability = capability or "none"
    env: Dict[str, Any] = {
        "torch": str(torch_version or torch.__version__),
        "cuda": str(cuda_version or torch.version.cuda),
        "nvcc": str(nvcc or nvcc_release()),
        "driver": str(driver or driver_version()),
        "device_name": str(device_name),
        "capability": str(capability),
        "python": f"{sys.version_info.major}.{sys.version_info.minor}",
    }
    fp = hashlib.sha256(
        repr(sorted(env.items(), key=lambda kv: kv[0])).encode()).hexdigest()
    return env, fp


def config_fingerprint(args: Dict[str, Any],
                       resolved: Optional[Dict[str, Any]] = None) -> str:
    """cache.py's canonical resolved-config fingerprint, reused verbatim:
    the compile cache and the feature cache agree on what "operationally
    different, semantically identical" means."""
    from .cache import config_fingerprint as _fp
    return _fp(args, resolved)


def resolved_overlay(args) -> Dict[str, Any]:
    """The ``resize=auto`` resolution predicted from the config alone (the
    entry is attached before the extractor exists): ``device`` for
    file-sink runs, ``host`` for print and ``show_pred``, as
    ``BaseExtractor`` resolves it; ``ingest`` when set."""
    resolved: Dict[str, Any] = {}
    rz = args.get("resize") or "auto"
    if rz == "auto":
        save_sink = args.get("on_extraction", "print") in (
            "save_numpy", "save_pickle")
        resolved["resize"] = ("device" if save_sink
                              and not args.get("show_pred") else "host")
    ingest = args.get("ingest")
    if ingest is not None:
        resolved["ingest"] = ingest
    return resolved


def entry_key(family: str, config_fp: str, env_fp: str) -> str:
    """One sha256 over the triple: the entry directory's name."""
    return hashlib.sha256(
        f"{family}\n{config_fp}\n{env_fp}".encode()).hexdigest()


def runs_kernels(family: str, args) -> bool:
    """Whether ``family``'s path under ``args`` launches the port's CUDA
    kernels: RAFT's correlation lookup, in the raft family and in i3d's
    flow stream with ``flow_type=raft``, unless ``corr_lookup_impl`` picks a
    plain lookup (``gather`` or ``onehot``)."""
    if args.get("corr_lookup_impl") in ("gather", "onehot"):
        return False
    if family == "raft":
        return True
    if family == "i3d":
        return args.get("flow_type") == "raft" and \
            args.get("streams") in (None, "flow")
    return False


# -- the entry ---------------------------------------------------------------

class CompileCacheEntry:
    """One ``(family, config, environment)`` triple's directory of built
    kernel libraries, with sealed-sum verification. ``kernels`` says whether
    the triple's path launches kernels at all (an entry without is warm on
    its manifest alone)."""

    def __init__(self, root: str, family: str, config_fp: str,
                 env_fp: str, env: Optional[Dict[str, Any]] = None,
                 kernels: bool = True) -> None:
        self.root = str(root)
        self.family = str(family)
        self.config_fp = config_fp
        self.env_fp = env_fp
        self.env = dict(env or {})
        self.kernels = bool(kernels)
        self.key = entry_key(self.family, config_fp, env_fp)
        self.dir = os.path.join(self.root, _safe(self.family),
                                self.key[:2], self.key)
        #: attach-time verdicts, published into the heartbeat section
        self.warm_at_attach = False
        self.verified = 0
        self.dropped = 0

    # -- inspection --------------------------------------------------------
    def _cache_files(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.dir)
                          if n.endswith(_LIB_SUFFIX)
                          or n.endswith(_REPORT_SUFFIX))
        except OSError:
            return []

    def _read_json(self, name: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, name), encoding="utf-8") as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    def sums(self) -> Dict[str, dict]:
        doc = self._read_json(SUMS_NAME) or {}
        files = doc.get("files")
        return dict(files) if isinstance(files, dict) else {}

    def manifest(self) -> Optional[dict]:
        return self._read_json(MANIFEST_NAME)

    def is_warm(self) -> bool:
        """True when this triple carries the warm promise: a manifest of
        the right schema and fingerprints, and (for a kernel path) sealed
        files that all still exist, the library of the current sources
        among them (:meth:`verify` has already deleted any that rotted)."""
        man = self.manifest()
        if man is None or man.get("schema") != SCHEMA_VERSION:
            return False
        if man.get("config_fp") != self.config_fp or \
                man.get("env_fp") != self.env_fp:
            return False
        if not self.kernels:
            return True
        from .kernels import build
        sums = self.sums()
        if build.library_name() not in sums:
            return False
        return all(os.path.exists(os.path.join(self.dir, name))
                   for name in sums)

    # -- verify / seal ------------------------------------------------------
    def verify(self) -> Dict[str, int]:
        """Re-hash every library and report against the sealed sums. A
        mismatch or an unsealed file is deleted (a library takes its
        report with it), so the build sees a clean miss and rebuilds
        instead of loading a corrupt library. Returns ``{"verified": n,
        "dropped": n}`` and records both on the entry."""
        sums = self.sums()
        verified = dropped = 0
        for name in self._cache_files():
            path = os.path.join(self.dir, name)
            if not os.path.exists(path):
                continue  # a report that went with its dropped library
            rec = sums.get(name)
            ok = False
            if isinstance(rec, dict):
                try:
                    ok = _sha256_file(path) == rec.get("sha256")
                except OSError:
                    ok = False
            if ok:
                verified += 1
                continue
            reason = "sha mismatch" if rec is not None else "never sealed"
            print(f"compile cache: dropped {name} ({reason}) — a clean "
                  f"rebuild replaces it ({self.dir})", file=sys.stderr)
            victims = [path]
            if name.endswith(_LIB_SUFFIX):
                victims.append(path + _REPORT_SUFFIX)
            for victim in victims:
                try:
                    os.unlink(victim)
                except OSError:
                    pass
            dropped += 1
        self.verified, self.dropped = verified, dropped
        return {"verified": verified, "dropped": dropped}

    def seal(self) -> int:
        """Record the current files' sums and the entry manifest (both
        atomic, ``telemetry/jsonl.py``): from here on the entry is warm.
        Called when a run exits; a run that dies first leaves unsealed
        files for the next attach to drop. Returns the sealed file
        count."""
        from .telemetry.jsonl import write_json_atomic
        files: Dict[str, dict] = {}
        for name in self._cache_files():
            path = os.path.join(self.dir, name)
            try:
                files[name] = {"sha256": _sha256_file(path),
                               "bytes": os.path.getsize(path)}
            except OSError:
                continue
        write_json_atomic(os.path.join(self.dir, SUMS_NAME),
                          {"schema": SCHEMA_VERSION, "files": files,
                           "time": round(time.time(), 3)})
        write_json_atomic(os.path.join(self.dir, MANIFEST_NAME), {
            "schema": SCHEMA_VERSION,
            "family": self.family,
            "config_fp": self.config_fp,
            "env_fp": self.env_fp,
            "env": self.env,
            "kernels": self.kernels,
            "files": len(files),
            "sealed_time": round(time.time(), 3),
        })
        return len(files)


# -- process-global attach ----------------------------------------------------

_lock = threading.Lock()
_active: Optional[CompileCacheEntry] = None


def resolve_root(args) -> Optional[str]:
    """The store root this run attaches to, or None (off).
    ``compile_cache=auto`` (the YAML default) is on for ``cuda`` runs and
    off on the CPU unless ``compile_cache_dir`` names a root (tests and
    casual CPU runs grow no store in ``$HOME``)."""
    mode = args.get("compile_cache", "auto")
    if mode in (None, False, "", "false", "null", "off"):
        return None
    if mode not in (True, "auto", "true", "on"):
        raise ValueError(f"compile_cache={mode!r}: expected true, false "
                         "or 'auto'")
    explicit = args.get("compile_cache_dir")
    if mode == "auto" and explicit is None and \
            not str(args.get("device") or "").startswith("cuda"):
        return None
    return str(explicit) if explicit else default_root()


def configure_build_dir(args) -> None:
    """``compilation_cache_dir``: the per-machine build directory that
    ``kernels/build.py`` uses when no entry is attached; ``auto`` or null
    keep the git-ignored ``kernels/_build/``."""
    from .kernels import build
    d = args.get("compilation_cache_dir")
    build.set_build_dir(None if d in (None, "auto") else str(d))


def _attach_entry(root: str, family: str, config_fp: str,
                  kernels: bool) -> CompileCacheEntry:
    """The shared attach tail: build the entry, verify-before-trust,
    record warmth, publish it as the process-global active entry (losers
    of the publish race return the winner), then have the kernel build
    take its library from the entry or build into it."""
    global _active
    env, env_fp = env_fingerprint()
    entry = CompileCacheEntry(root, family, config_fp, env_fp, env=env,
                              kernels=kernels)
    with _lock:
        if _active is not None:
            return _active
        _active = entry
    os.makedirs(entry.dir, exist_ok=True)
    entry.verify()
    entry.warm_at_attach = entry.is_warm()
    if kernels:
        from .kernels import build
        build.build()
    return entry


def attach(family: str, args, resolved: Optional[Dict[str, Any]] = None
           ) -> Optional[CompileCacheEntry]:
    """Attach this process to the triple's entry: verify, remember, build.
    First attach wins; later calls return the active entry unchanged.
    None when ``compile_cache`` resolves off."""
    with _lock:
        if _active is not None:
            return _active
    root = resolve_root(args)
    if root is None:
        return None
    return _attach_entry(root, family, config_fingerprint(args, resolved),
                         runs_kernels(family, args))


def attach_for_args(family: str, args) -> Optional[CompileCacheEntry]:
    """Attach from a sanity-checked config, before the extractor is
    constructed (the resolution overlay predicted from the config)."""
    return attach(str(family), args, resolved_overlay(args))


def attach_for_multi_args(per_family) -> Optional[CompileCacheEntry]:
    """A multi-family run attaches one combined entry: family = the
    comma-joined list, the config fingerprint a hash over every member's
    own resolved fingerprint (order-insensitive); it runs kernels when any
    member does. ``warmup resnet,clip`` warms exactly this triple."""
    families = list(per_family)
    fps = []
    for fam in sorted(families):
        a = per_family[fam]
        fps.append(f"{fam}:{config_fingerprint(a, resolved_overlay(a))}")
    combined = hashlib.sha256("\n".join(fps).encode()).hexdigest()
    with _lock:
        if _active is not None:
            return _active
    root = resolve_root(per_family[families[0]])
    if root is None:
        return None
    return _attach_entry(root, ",".join(families), combined,
                         any(runs_kernels(f, per_family[f])
                             for f in families))


def active() -> Optional[CompileCacheEntry]:
    with _lock:
        return _active


def active_info() -> Optional[Dict[str, Any]]:
    """Compact view of the attached entry for heartbeats and reports."""
    entry = active()
    if entry is None:
        return None
    return {"family": entry.family, "entry": entry.key[:12],
            "warm_at_attach": bool(entry.warm_at_attach),
            "verified": entry.verified, "dropped": entry.dropped,
            "dir": entry.dir}


def seal_active() -> int:
    """Seal the attached entry (run exit). Returns the sealed file count;
    0 when nothing is attached. Never raises into the caller's finally: an
    unsealed entry only costs the next host a rebuild."""
    entry = active()
    if entry is None:
        return 0
    try:
        return entry.seal()
    except Exception as e:
        print(f"compile cache: seal failed ({type(e).__name__}: {e}) — "
              f"entry stays cold, the next attach rebuilds",
              file=sys.stderr)
        return 0


def detach_for_tests() -> None:
    """Drop the process-global attach so tests can re-attach."""
    global _active
    with _lock:
        _active = None


# -- hit / miss accounting -----------------------------------------------------

def snapshot() -> Dict[str, float]:
    """The kernel build's process-wide counts (``kernels/build.py``)."""
    from .kernels import build
    return build.build_counts()


def summary(baseline: Dict[str, float]) -> Dict[str, Any]:
    """The build's hits and misses since ``baseline`` (a
    :func:`snapshot`), with ``nvcc_s``, the seconds ``nvcc`` ran, when it
    ran: the shape of the JAX heartbeat's ``compile_cache`` counters."""
    now = snapshot()
    out: Dict[str, Any] = {
        "hits": int(now["hits"] - baseline.get("hits", 0)),
        "misses": int(now["misses"] - baseline.get("misses", 0))}
    nvcc_s = now["nvcc_s"] - baseline.get("nvcc_s", 0.0)
    if nvcc_s > 0:
        out["nvcc_s"] = round(nvcc_s, 3)
    return out


def section(baseline: Dict[str, float]) -> Dict[str, Any]:
    """The heartbeat's and manifest's ``compile_cache`` section: the
    counts since ``baseline`` and, when an entry is attached, its key,
    family, warmth at attach and the verify verdicts. ``hits > 0,
    misses == 0`` is the warm-join shape."""
    out = summary(baseline)
    info = active_info()
    if info is not None:
        out.update(entry=info["entry"], family=info["family"],
                   warm_at_attach=info["warm_at_attach"],
                   verified=info["verified"], dropped=info["dropped"])
    return out


# -- ahead-of-time warmup ------------------------------------------------------

def _warmup_one(spec: str, overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Warm one triple in this process: the sanity-checked config of
    ``spec`` (a family, or a comma list for the combined entry), attach
    (which builds the kernels into the entry when the path runs them),
    seal. No video is read: the build is the only compile the port has.
    The warmup subprocesses call this; tests may call it directly."""
    from .config import (load_config, load_multi_config, sanity_check,
                         sanity_check_multi)
    from .registry import parse_feature_types

    overrides = dict(overrides or {})
    # the warmup's config resolves like a production file-sink run's
    overrides.setdefault("on_extraction", "save_numpy")
    # the entry point exists to populate the store: an absent or auto key
    # attaches on the CPU too (the operator asked for warmth)
    if overrides.get("compile_cache") in (None, "auto"):
        overrides["compile_cache"] = True
    overrides.pop("video_paths", None)
    overrides.pop("file_with_video_paths", None)
    families = parse_feature_types(spec)
    baseline = snapshot()
    t0 = time.perf_counter()
    if len(families) > 1:
        per_family = load_multi_config(families, overrides)
        sanity_check_multi(per_family, require_videos=False)
        configure_build_dir(per_family[families[0]])
        entry = attach_for_multi_args(per_family)
    else:
        cfg = load_config(families[0], overrides)
        sanity_check(cfg, require_videos=False)
        configure_build_dir(cfg)
        entry = attach_for_args(families[0], cfg)
    if entry is None:
        return {"family": spec, "status": "disabled",
                "note": "compile_cache resolved off (compile_cache=false?)"}
    counts = summary(baseline)
    return {"family": spec, "status": "ok", "entry": entry.key[:12],
            "dir": entry.dir, "warm_before": bool(entry.warm_at_attach),
            "kernels": entry.kernels,
            "compiled": counts["misses"], "reused": counts["hits"],
            "sealed_files": entry.seal(),
            "seconds": round(time.perf_counter() - t0, 2)}


_WARMUP_WORKER = """\
import json, sys
result = {}
try:
    from video_features_tpu_torch.compile_cache import _warmup_one
    result = _warmup_one(sys.argv[1], json.loads(sys.argv[2]))
except BaseException as e:
    result = {"family": sys.argv[1], "status": "error",
              "error": f"{type(e).__name__}: {e}"}
print("VFT_WARMUP_RESULT " + json.dumps(result))
"""


def _spawn_warmup(spec: str, over) -> Dict[str, Any]:
    """:func:`_warmup_one` in a fresh subprocess: the attach is
    process-global, and a cold process is the joining-host shape the
    warmth is for."""
    from .cache import _plain
    proc = subprocess.run(
        [sys.executable, "-c", _WARMUP_WORKER, spec,
         json.dumps(_plain(dict(over)))],
        capture_output=True, text=True)
    for line in reversed((proc.stdout or "").splitlines()):
        if line.startswith("VFT_WARMUP_RESULT "):
            try:
                return json.loads(line[len("VFT_WARMUP_RESULT "):])
            except ValueError:
                break
    tail = (proc.stderr or proc.stdout or "")[-800:]
    return {"family": spec, "status": "error",
            "error": f"warmup subprocess rc={proc.returncode}: {tail}"}


def warmup_main(argv: Optional[List[str]] = None) -> None:
    """``python -m video_features_tpu_torch warmup <family>[,<family>...]
    ... [key=value ...]``: build and seal every listed spec's entry ahead
    of time, one fresh subprocess per spec. ``feature_type=`` names a spec
    too, so a run's own arguments warm its own entry. Exit 1 when a spec
    failed."""
    argv = list(sys.argv[1:] if argv is None else argv)
    specs: List[str] = []
    overrides: List[str] = []
    for a in argv:
        if a.startswith("feature_type="):
            specs.append(a.split("=", 1)[1])
        else:
            (overrides if "=" in a else specs).append(a)
    if not specs:
        raise SystemExit(
            "Usage: python -m video_features_tpu_torch warmup "
            "<family>[,<family>...] ... [key=value ...]\n"
            "e.g.   ... warmup i3d flow_type=raft compile_cache_dir=/srv/cc")
    from .config import parse_dotlist
    from .registry import parse_feature_types
    over = parse_dotlist(overrides)
    failures = 0
    for spec in specs:
        parse_feature_types(spec)  # validates the names
        result = _spawn_warmup(spec, over)
        if result.get("status") == "ok":
            tag = ("warm already, re-verified" if result.get("warm_before")
                   else f"built {result.get('compiled', '?')} library(ies)")
            print(f"warmup: {spec}: {tag} in {result.get('seconds', '?')}s "
                  f"-> entry {result.get('entry')} "
                  f"({result.get('sealed_files')} sealed file(s), "
                  f"{result.get('dir')})")
        else:
            failures += 1
            print(f"warmup: {spec}: FAILED — "
                  f"{result.get('note') or result.get('error')}",
                  file=sys.stderr)
    if failures:
        raise SystemExit(1)
