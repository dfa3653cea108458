"""Weight resolution: find the checkpoint of a model key and load it into
the port's module (port of ``video_features_tpu/weights/store.py``).

The search order is the JAX package's (:func:`find_checkpoint`):

  1. an explicit weights path from the config (a torch ``.pt``/``.pth``
     file in the reference's layout, or a JAX-converted ``.msgpack``);
  2. ``VFT_WEIGHTS_DIR`` (default ``~/.cache/video_features_tpu``, shared
     with the JAX package): ``{model_key}.msgpack``, ``.pt``, ``.pth``;
  3. each upstream filename of the key (:data:`HUB_FILENAMES`) in the
     torch hub cache (``$TORCH_HOME/hub/checkpoints``), then in
     ``VFT_WEIGHTS_DIR``;
  4. with ``VFT_FETCH_WEIGHTS=1`` on a networked host, a download from the
     reference's upstream sources (:func:`fetch_checkpoint`), checked
     against the published SHA-256 where there is one, and where there is
     none against the digest recorded on the first fetch (``ref_digests.
     json``); the reference's own pickled blobs are refused from a mutable
     branch unless ``VFT_REF_COMMIT`` pins a commit or
     ``VFT_ALLOW_MUTABLE_REF=1`` accepts the risk;
  5. the seeded random init, only with ``allow_random_weights``.

A ``.msgpack`` is the JAX package's converted flax tree (its
``resolve_params`` writes ``{model_key}.msgpack`` beside a torch
checkpoint it converted). The port reads it without ``flax`` and without
the ``msgpack`` package (:func:`read_msgpack`, the subset flax's
``serialization.to_bytes`` writes) and maps the tree onto its module with
``weights/bridge.py`` (``weights/converters.py``). The port writes no
``.msgpack`` of its own, where JAX's ``save_msgpack`` would: it loads the
reference's torch layout directly, so it has nothing to convert.

:func:`resolve_params` records what it loaded on the thread's capture
(:func:`start_weights_capture`): ``{model_key, path, sha256}`` or
``{model_key, random: True}``, which ``cache.py`` folds into the feature
cache's key, as the JAX package does.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# known torch-hub / CDN filenames per model key, for cache probing
HUB_FILENAMES: Dict[str, tuple] = {
    "resnet18": ("resnet18-f37072fd.pth", "resnet18-5c106cde.pth"),
    "resnet34": ("resnet34-b627a593.pth", "resnet34-333f7ec4.pth"),
    "resnet50": ("resnet50-0676ba61.pth", "resnet50-19c8e357.pth"),
    "resnet101": ("resnet101-63fe2227.pth", "resnet101-5d3b4d8f.pth"),
    "resnet152": ("resnet152-394f9c45.pth", "resnet152-b121ed2d.pth"),
    "r2plus1d_18_16_kinetics": ("r2plus1d_18-91a641e6.pth",),
    "r2plus1d_34_32_ig65m_ft_kinetics": ("r2plus1d_34_clip32_ig65m_from_scratch-449a7af9.pth",),
    "r2plus1d_34_8_ig65m_ft_kinetics": ("r2plus1d_34_clip8_ig65m_from_scratch-9bae36ae.pth",),
    # repo-local checkpoints of the reference; the same filenames are
    # accepted in VFT_WEIGHTS_DIR
    "raft_sintel": ("raft-sintel.pth",),
    "raft_kitti": ("raft-kitti.pth",),
    "i3d_rgb": ("i3d_rgb.pt",),
    "i3d_flow": ("i3d_flow.pt",),
    "s3d_kinetics400": ("S3D_kinetics400_torchified.pt",),
    "pwc_sintel": ("pwc_net_sintel.pt",),
    # torchvggish GitHub release filenames (reference vggish_slim.py:122-127)
    "vggish": ("vggish-10086976.pth",),
    "vggish_pca": ("vggish_pca_params-970ea276.pth", "vggish_pca_params.npz"),
    # OpenAI CDN filenames (reference clip_src/clip.py:32-42); TorchScript
    # archives are unwrapped by torch_import.load_torch_state_dict
    "clip_RN50": ("RN50.pt",),
    "clip_RN101": ("RN101.pt",),
    "clip_RN50x4": ("RN50x4.pt",),
    "clip_RN50x16": ("RN50x16.pt",),
    "clip_RN50x64": ("RN50x64.pt",),
    "clip_ViT-B-32": ("ViT-B-32.pt",),
    "clip_ViT-B-16": ("ViT-B-16.pt",),
    "clip_ViT-L-14": ("ViT-L-14.pt",),
    "clip_ViT-L-14-336px": ("ViT-L-14-336px.pt",),
}

#: full published SHA-256 digests: the OpenAI CDN embeds them in the
#: download URL path and the reference's _download() verifies exactly this
#: digest (reference models/clip/clip_src/clip.py:32-42,61-73)
CLIP_SHA256: Dict[str, str] = {
    "RN50.pt": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101.pt": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4.pt": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16.pt": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "RN50x64.pt": "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c",
    "ViT-B-32.pt": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B-16.pt": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
    "ViT-L-14.pt": "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836",
    "ViT-L-14-336px.pt": "3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02",
}

_TORCH_CDN = "https://download.pytorch.org/models/"
_IG65M = "https://github.com/moabitcoin/ig65m-pytorch/releases/download/v1.0.0/"
_VGGISH = "https://github.com/harritaylor/torchvggish/releases/download/v0.1/"
#: the reference vendors these blobs inside its own git tree; raw-file URLs
#: are their only public source. They are PICKLED torch checkpoints with no
#: published digest, so a mutable branch ref is an arbitrary-code-execution
#: hazard (a moved or compromised branch swaps the bytes under the same
#: URL). Downloads therefore need an immutable commit pin
#: (``VFT_REF_COMMIT=<sha>``, read at import so the URLs are immutable);
#: without one the fetcher REFUSES these files unless
#: ``VFT_ALLOW_MUTABLE_REF=1``. Either way the first fetch records the
#: file's SHA-256 in ``{weights_dir}/ref_digests.json`` and every later
#: fetch verifies against it (trust on first use).
_REF_COMMIT = os.environ.get("VFT_REF_COMMIT", "")
_REF_RAW = ("https://github.com/habakan/video_features/raw/"
            f"{_REF_COMMIT or 'master'}/")
#: upstream filenames served from the reference repo's git tree (the
#: unpinned-pickle set the mutable-ref refusal applies to)
REF_FILES = frozenset({
    "raft-sintel.pth", "raft-kitti.pth", "i3d_rgb.pt", "i3d_flow.pt",
    "S3D_kinetics400_torchified.pt", "pwc_net_sintel.pt",
})

#: upstream URL per filename: the sources the reference downloads from (or,
#: for its repo-local blobs, vendors)
WEIGHT_URLS: Dict[str, str] = {
    **{f: _TORCH_CDN + f for key in ("resnet18", "resnet34", "resnet50",
                                     "resnet101", "resnet152",
                                     "r2plus1d_18_16_kinetics")
       for f in HUB_FILENAMES[key]},
    **{f: _IG65M + f for key in ("r2plus1d_34_32_ig65m_ft_kinetics",
                                 "r2plus1d_34_8_ig65m_ft_kinetics")
       for f in HUB_FILENAMES[key]},
    "vggish-10086976.pth": _VGGISH + "vggish-10086976.pth",
    "vggish_pca_params-970ea276.pth": _VGGISH + "vggish_pca_params-970ea276.pth",
    **{f: f"https://openaipublic.azureedge.net/clip/models/{sha}/{f}"
       for f, sha in CLIP_SHA256.items()},
    "raft-sintel.pth": _REF_RAW + "models/raft/checkpoints/raft-sintel.pth",
    "raft-kitti.pth": _REF_RAW + "models/raft/checkpoints/raft-kitti.pth",
    "i3d_rgb.pt": _REF_RAW + "models/i3d/checkpoints/i3d_rgb.pt",
    "i3d_flow.pt": _REF_RAW + "models/i3d/checkpoints/i3d_flow.pt",
    "S3D_kinetics400_torchified.pt":
        _REF_RAW + "models/s3d/checkpoint/S3D_kinetics400_torchified.pt",
    "pwc_net_sintel.pt": _REF_RAW + "models/pwc/checkpoints/pwc_net_sintel.pt",
}


def weights_dir() -> Path:
    return Path(os.environ.get(
        "VFT_WEIGHTS_DIR", os.path.expanduser("~/.cache/video_features_tpu")))


def expected_digest(fname: str) -> Tuple[Optional[str], Optional[str]]:
    """``(kind, digest)`` for an upstream filename: ``'sha256'`` (full,
    CLIP CDN), ``'sha256-prefix'`` (the 8-hex tail torch-hub release names
    embed, e.g. ``resnet18-f37072fd.pth``), or ``(None, None)`` for the
    reference's repo-local blobs, which publish no digest."""
    if fname in CLIP_SHA256:
        return "sha256", CLIP_SHA256[fname]
    stem = Path(fname).stem
    if "-" in stem:
        tail = stem.rsplit("-", 1)[1]
        if len(tail) == 8 and all(c in "0123456789abcdef" for c in tail):
            return "sha256-prefix", tail
    return None, None


def _digest_registry_path() -> Path:
    return weights_dir() / "ref_digests.json"


def recorded_digest(fname: str) -> Optional[str]:
    """The SHA-256 recorded for ``fname`` on an earlier fetch (trust on
    first use, for files with no published digest)."""
    try:
        with open(_digest_registry_path()) as f:
            return json.load(f).get(fname)
    except (OSError, ValueError):
        return None


def record_digest(fname: str, sha256: str) -> None:
    from ..utils.sinks import _write_bytes_atomic
    path = _digest_registry_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    data[fname] = sha256
    _write_bytes_atomic(str(path), json.dumps(data, indent=2,
                                              sort_keys=True).encode())


#: a ``.part`` download older than this is litter from a fetcher that died
#: mid-stream (SIGKILL skips every unlink-on-failure handler): no live
#: download runs this long, so the next fetch sweeps it
PART_STALE_S = 3600.0


def sweep_stale_parts(wd: Path, *, now: Optional[float] = None,
                      stale_s: float = PART_STALE_S) -> int:
    """Delete ``*.part`` files older than ``stale_s``; younger ones may be
    a concurrent fetcher's live download. Returns the count."""
    now = time.time() if now is None else float(now)
    swept = 0
    try:
        parts = sorted(Path(wd).glob("*.part"))
    except OSError:
        return 0
    for p in parts:
        try:
            if now - p.stat().st_mtime < stale_s:
                continue
            p.unlink()
            swept += 1
            print(f"weights: swept stale download litter {p.name}")
        except OSError:
            pass  # a sibling sweeper won the race, or permissions: both fine
    return swept


def fetch_checkpoint(model_key: str) -> Optional[Path]:
    """Download ``model_key``'s upstream checkpoint into
    :func:`weights_dir`, hashing while streaming, and rename it into place
    only when the digest holds (a published one, else the one recorded on
    the first fetch, which an unverified first fetch records). Called only
    with ``VFT_FETCH_WEIGHTS=1`` (:func:`find_checkpoint`)."""
    import urllib.request
    wd = weights_dir()
    if wd.is_dir():
        sweep_stale_parts(wd)
    for fname in HUB_FILENAMES.get(model_key, ()):
        url = WEIGHT_URLS.get(fname)
        if url is None:
            continue
        dest = wd / fname
        kind, digest = expected_digest(fname)
        recorded = None
        if kind is None:
            if (fname in REF_FILES and not _REF_COMMIT
                    and os.environ.get("VFT_ALLOW_MUTABLE_REF") != "1"):
                raise RuntimeError(
                    f"{fname}: refusing to download a pickled checkpoint "
                    "from the MUTABLE 'master' ref of the reference repo "
                    "(torch.load is pickle — a moved or compromised branch "
                    "means arbitrary code execution). Pin an immutable "
                    "commit with VFT_REF_COMMIT=<sha>, or set "
                    "VFT_ALLOW_MUTABLE_REF=1 to accept the risk, or drop "
                    f"the file into {wd} yourself.")
            recorded = recorded_digest(fname)
            if recorded:
                print(f"{fname}: verifying against the SHA-256 recorded on "
                      f"first fetch ({_digest_registry_path()})")
            else:
                print(f"WARNING: no published digest for {fname}; "
                      f"downloading unverified from {url} (its SHA-256 "
                      "will be recorded for future fetches)")
        wd.mkdir(parents=True, exist_ok=True)
        # a per-process temp name: fetchers sharing a weights dir never
        # write into one .part file
        fd, part_name = tempfile.mkstemp(prefix=fname + ".", suffix=".part",
                                         dir=wd)
        part = Path(part_name)
        h = hashlib.sha256()
        # vft-lint: disable=VFT004 — verify-then-promote: the .part download is sha256-checked before the rename, a torn stream can never be promoted
        out = os.fdopen(fd, "wb")
        try:
            # the socket timeout also bounds a stall mid-stream
            with out, urllib.request.urlopen(url, timeout=60) as src:
                while True:
                    chunk = src.read(1 << 20)
                    if not chunk:
                        break
                    h.update(chunk)
                    out.write(chunk)
        except OSError as e:  # URLError is an OSError
            part.unlink(missing_ok=True)
            raise RuntimeError(
                f"VFT_FETCH_WEIGHTS=1: download of {url} failed ({e}). "
                "On an offline host, unset the flag and drop the file into "
                f"{wd} instead.") from e
        except BaseException:
            part.unlink(missing_ok=True)
            raise
        got = h.hexdigest()
        ok = ((kind is None and (recorded is None or got == recorded)) or
              (kind == "sha256" and got == digest) or
              (kind == "sha256-prefix" and got.startswith(digest)))
        if not ok:
            part.unlink(missing_ok=True)
            which = (f"recorded digest (sha256:{recorded})" if kind is None
                     else f"published digest ({kind}:{digest})")
            raise RuntimeError(
                f"{fname}: downloaded file's SHA-256 {got[:16]}... does not "
                f"match the {which}; refusing to use it")
        os.replace(part, dest)
        if kind is None and recorded is None:
            record_digest(fname, got)
        verdict = (f" [{kind} verified]" if kind
                   else " [recorded sha256 verified]" if recorded
                   else f" [UNVERIFIED; sha256 {got[:16]}... recorded]")
        print(f"fetched {fname} -> {dest}{verdict}")
        return dest
    return None


def find_checkpoint(model_key: str,
                    explicit_path: Optional[str] = None) -> Optional[Path]:
    """The weight file of ``model_key`` in the module docstring's order
    (``.msgpack`` before the torch files), or None."""
    if explicit_path:
        p = Path(explicit_path)
        if not p.exists():
            raise FileNotFoundError(f"weights_path does not exist: {p}")
        return p
    wd = weights_dir()
    for ext in (".msgpack", ".pt", ".pth"):
        p = wd / f"{model_key}{ext}"
        if p.exists():
            return p
    torch_home = Path(os.environ.get("TORCH_HOME",
                                     os.path.expanduser("~/.cache/torch")))
    for fname in HUB_FILENAMES.get(model_key, ()):
        for p in (torch_home / "hub" / "checkpoints" / fname, wd / fname):
            if p.exists():
                return p
    if os.environ.get("VFT_FETCH_WEIGHTS") == "1":
        return fetch_checkpoint(model_key)
    return None


# -- flax's msgpack ------------------------------------------------------------

#: flax ``serialization._MsgpackExtType``
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder of what flax's ``to_bytes`` writes: maps, arrays,
    strings, bytes, ints, floats, bools, nil and its ndarray, scalar and
    complex extension types."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.uint(1 << (b - 0xc4))))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.uint(1 << (b - 0xc7))
            return self.ext(self.uint(1), n)
        if b == 0xca:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= b <= 0xcf:
            return self.uint(1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:
            n = 1 << (b - 0xd0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xd4 <= b <= 0xd8:
            code = self.uint(1)
            return self.ext(code, 1 << (b - 0xd4))
        if 0xd9 <= b <= 0xdb:
            return str(self.take(self.uint(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):
            return [self.value() for _ in range(self.uint(2 if b == 0xdc
                                                          else 4))]
        if b in (0xde, 0xdf):
            return self.map(self.uint(2 if b == 0xde else 4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload).value()
            name = dtype.decode() if isinstance(dtype, bytes) else dtype
            if name == "bfloat16":
                raise ValueError("msgpack: a bfloat16 array (the store "
                                 "converts to float32; re-convert it)")
            arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: unsupported extension type {code}")


def _unchunk(tree: Any) -> Any:
    """flax's chunked leaves (arrays above 2**30 bytes) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        def ordered(d):
            return [d[str(i)] for i in range(len(d))]
        shape = tuple(ordered(tree["shape"]))
        return np.concatenate(ordered(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(data: bytes) -> Any:
    """The tree of flax ``serialization.to_bytes``: nested dicts with
    numpy leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


def load_msgpack(path: Path) -> Any:
    with open(path, "rb") as f:
        return read_msgpack(f.read())


def load_state(path: Path, model_key: str) -> Dict[str, Any]:
    """The state dict in the port's (the reference's) layout of the file at
    ``path``: a ``.msgpack`` mapped through the key's bridge, else a torch
    checkpoint."""
    if Path(path).suffix == ".msgpack":
        from .converters import registry
        to_state = registry().get(model_key)
        if to_state is None:
            raise ValueError(f"{path}: no converter for model key "
                             f"{model_key!r}")
        return to_state(load_msgpack(path))
    from .torch_import import load_torch_state_dict
    return load_torch_state_dict(str(path))


# -- weights identity for the feature cache's key (cache.py) -----------------

_capture_tls = threading.local()


def start_weights_capture() -> list:
    """Begin a fresh capture on this thread; returns the live list that
    later :func:`resolve_params` calls on this thread append to. Each call
    replaces the active list, so extractors built one after another (a
    multi-family run) each keep only their own resolutions."""
    cap: list = []
    _capture_tls.capture = cap
    return cap


def record_resolution(model_key: str, path: Optional[Path]) -> None:
    """Record on this thread's capture what was loaded for ``model_key``:
    ``{model_key, path, sha256}``, or ``{model_key, random: True}`` for the
    seeded init (``path`` None)."""
    cap = getattr(_capture_tls, "capture", None)
    if cap is None:
        return
    if path is None:
        cap.append({"model_key": model_key, "random": True})
        return
    from ..cache import file_sha256
    try:
        cap.append({"model_key": model_key, "path": str(path),
                    "sha256": file_sha256(str(path))})
    except OSError:
        pass  # keying metadata: an unreadable file fails its load instead


def resolve_params(module, model_key: str,
                   weights_path: Optional[str] = None,
                   allow_random: bool = False, seed: int = 0,
                   prepare: Optional[Callable[[Dict[str, Any]],
                                              Dict[str, Any]]] = None):
    """``module`` with ``model_key``'s weights (:func:`find_checkpoint`,
    loaded ``strict``, through ``prepare`` when given), else the seeded
    random init with ``allow_random``, else ``FileNotFoundError`` naming
    :func:`weights_dir`. Returns ``module``."""
    ckpt = find_checkpoint(model_key, weights_path)
    if ckpt is None:
        if not allow_random:
            raise FileNotFoundError(
                f"No weights for {model_key!r}. Provide `weights_path=...`, "
                f"drop a checkpoint into {weights_dir()}, or set "
                "`allow_random_weights=true` for throughput-only runs. Known "
                "source filenames: "
                f"{HUB_FILENAMES.get(model_key, '(model-specific)')}")
        print(f"WARNING: no weights found for {model_key!r}; using RANDOM "
              "init (allow_random_weights=true). Features will be "
              "meaningless — for tests/benchmarks only.")
        record_resolution(model_key, None)
        from .bridge import seeded_init_
        return seeded_init_(module, seed)
    record_resolution(model_key, ckpt)
    state = load_state(ckpt, model_key)
    module.load_state_dict(prepare(state) if prepare else state, strict=True)
    return module
