"""Build the port's CUDA kernels at first use and bind them with ``ctypes``.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into one shared library with
a plain C interface; nothing includes PyTorch's headers, so a build takes
seconds, not the minutes a ``torch.utils.cpp_extension`` build of the same
source takes. The library lands in ``kernels/_build/`` (git-ignored), named
by a digest of its sources and flags, so an edited source is rebuilt and a
stale library is never loaded. Each C entry point returns the launch's
``cudaError_t``; the wrappers raise when it is not 0.

Nothing here runs at import time: a build happens the first time a kernel
wrapper is handed a CUDA tensor, so importing the package needs no toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
#: C signatures of csrc/corr_lookup.cu (pointers and the stream as c_void_p:
#: ctypes would otherwise pass them as 32-bit ints and cut them)
_SIGNATURES = {
    "vft_corr_lookup_level": [_P, _I, _I, _P, _L, _I, _P, _I, _I, _P],
    "vft_corr_lookup_proj": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I,
                             _P, _L, _P, _P, _I, _P, _P],
    # geometry: a host array of 4 x (h, w, j, k, off) ints
    "vft_corr_lookup_packed": [_P, _L, _P, _L, _P, _P, _P],
}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return found


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvft_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Writes to a temporary name and renames, so a cut build never leaves a
    library that looks complete."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vft_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.vft_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
