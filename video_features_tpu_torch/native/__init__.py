"""Native (C++) host IO: built on first use, bound with ctypes, always
optional (port of ``video_features_tpu/native/``).

``vft_native.cpp`` (the port's own copy of the JAX package's source) is
compiled with ``g++`` into ``native/_build/vft_native-<sha1>.so`` beside
this file (git-ignored) on first use: a plain ``extern "C"`` interface, no
PyTorch headers. The build writes a temporary name and renames it into
place, so workers that race to build get the whole library or none. Every
entry point has a Python fallback at its call site (``utils/sinks.py``),
so the port runs unchanged where no compiler is found; ``VFT_NATIVE=0``
forces the fallbacks.

  available()               -> bool
  write_npy_atomic(path, a) -> write a .npy through a temp file, fsync and
                               rename; False where the native path cannot
  validate_npy(path)        -> structural check of a .npy, O(header)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("vft_native.cpp")
#: where the library is built (git-ignored)
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """The library of this source: its name carries the source's sha1."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"vft_native-{tag}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if os.environ.get("VFT_NATIVE", "").strip() == "0":
            _build_failed = True
            return None
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.vft_write_npy.restype = ctypes.c_int
            lib.vft_write_npy.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64]
            lib.vft_validate_npy.restype = ctypes.c_int
            lib.vft_validate_npy.argtypes = [ctypes.c_char_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            # no compiler, an unwritable build dir, a library that does not
            # load: the Python fallbacks run
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def write_npy_atomic(fpath: str, value) -> bool:
    """Write ``value`` as .npy and rename it into place. Returns False
    where the native path cannot (an object or structured dtype, or no
    library): the caller falls back to the Python writer. A non-contiguous
    input is copied to C order first."""
    lib = _load()
    if lib is None:
        return False
    arr = np.asanyarray(value)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        return False
    # np.save appends '.npy' when missing: keep that contract
    if not str(fpath).endswith(".npy"):
        fpath = str(fpath) + ".npy"
    if not arr.flags.c_contiguous:
        # not np.ascontiguousarray unconditionally: it makes a 0-d array (1,)
        arr = np.ascontiguousarray(arr)
    shape = (ctypes.c_int64 * max(arr.ndim, 1))(*arr.shape)
    rc = lib.vft_write_npy(
        str(fpath).encode(), arr.dtype.str.encode(), shape, arr.ndim,
        arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(arr.nbytes))
    if rc != 0:
        raise OSError(f"vft_write_npy({fpath}) failed: {rc} "
                      f"({os.strerror(-rc) if -rc < 1000 else 'format'})")
    return True


def validate_npy(fpath: str) -> Optional[bool]:
    """True: structurally valid; False: corrupt or truncated; None: cannot
    judge natively (no library, a header it does not parse, an OS error),
    and the caller loads the file instead."""
    lib = _load()
    if lib is None:
        return None
    rc = lib.vft_validate_npy(str(fpath).encode())
    if rc == 0:
        return True
    if rc in (-1000, -1001):  # VFT_EFORMAT, VFT_ETRUNCATED
        return False
    return None
