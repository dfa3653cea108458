"""Build the port's CUDA kernels at first use and bind them with ``ctypes``.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into one shared library with
a plain C interface; nothing includes PyTorch's headers, so a build takes
seconds, not the minutes a ``torch.utils.cpp_extension`` build of the same
source takes. The library is named by a digest of its sources and flags,
so an edited source is rebuilt and a stale library is never loaded. It
lands in the attached compile-cache entry (``compile_cache.py``), which
verified it on attach and seals it at exit, or, with none attached, in the
per-machine build directory: ``compilation_cache_dir``, by default the
git-ignored ``kernels/_build/``, or, where the installed package cannot be
written, the per-user cache ``$XDG_CACHE_HOME/video_features_tpu_torch/
kernels`` (``utils/build_dirs.py``). Each :func:`build` counts a hit (the
library was there: no ``nvcc``) or a miss (``nvcc`` ran), read by
:func:`build_counts`; a miss says on stderr where it built and how long
``nvcc`` took. A failed ``nvcc`` raises: no kernel falls back to its plain
version. Each C entry point returns the launch's ``cudaError_t``; the
wrappers raise when it is not 0. ``-Xptxas -v`` makes
the compiler report each kernel's registers, shared memory and spills; the
report is kept beside the library (``<library>.ptxas.txt``) and
:func:`kernel_resources` reads it.

Nothing here runs at import time: a build happens the first time a kernel
wrapper is handed a CUDA tensor, so importing the package needs no toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
#: C signatures of csrc/corr_lookup.cu (pointers and the stream as c_void_p:
#: ctypes would otherwise pass them as 32-bit ints and cut them)
_SIGNATURES = {
    # vft-lint: disable=VFT005 — a C symbol of the kernel library, not a metric name
    "vft_corr_lookup_level": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I,
                              _P, _L, _P, _P],
    # vft-lint: disable=VFT005 — a C symbol of the kernel library, not a metric name
    "vft_corr_lookup_proj": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I,
                             _P, _L, _P, _P, _P, _P],
    # the geometry argument: a host array of 4 x (h, w, j, k, off) ints
    # vft-lint: disable=VFT005 — a C symbol of the kernel library, not a metric name
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


#: the per-machine build directory when no compile-cache entry is attached
#: (``compilation_cache_dir``); None is :data:`BUILD_DIR`
_build_dir: Optional[Path] = None
_counts_lock = threading.Lock()
_counts = {"hits": 0, "misses": 0, "nvcc_s": 0.0}


def set_build_dir(path: Optional[str]) -> None:
    """Point the build at ``path`` (None: :data:`BUILD_DIR`)."""
    global _build_dir
    _build_dir = None if path is None else Path(path)


def build_counts() -> Dict[str, float]:
    """This process's build hits, misses and seconds in ``nvcc``."""
    with _counts_lock:
        return dict(_counts)


def library_name() -> str:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"libvft_kernels_{digest.hexdigest()[:16]}.so"


def library_dir() -> Path:
    """The attached compile-cache entry's directory, else the directory
    :func:`set_build_dir` named, else :data:`BUILD_DIR` where it can be
    written, else the per-user cache."""
    from .. import compile_cache
    from ..utils.build_dirs import build_dir
    entry = compile_cache.active()
    if entry is not None:
        return Path(entry.dir)
    if _build_dir is not None:
        return _build_dir
    return build_dir(BUILD_DIR, "kernels")


def library_path() -> Path:
    return library_dir() / library_name()


def report_path(lib: Path) -> Path:
    """The compiler's ``-Xptxas -v`` report kept beside ``lib``."""
    return lib.with_name(lib.name + ".ptxas.txt")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists
    (a hit), else run ``nvcc`` (a miss). Writes to a temporary name and
    renames, so a cut build never leaves a library that looks complete;
    the ptxas report is written first."""
    lib = library_path()
    if lib.exists():
        with _counts_lock:
            _counts["hits"] += 1
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        report_path(lib).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        took = time.perf_counter() - t0
        with _counts_lock:
            _counts["misses"] += 1
            _counts["nvcc_s"] += took
    print(f"kernels: nvcc built {lib} in {took:.3f} s", file=sys.stderr)
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


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FIELDS = {"stack_frame_bytes": re.compile(r"(\d+) bytes stack frame"),
           "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
           "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
           "registers": re.compile(r"Used (\d+) registers"),
           "smem_bytes": re.compile(r"(\d+) bytes smem")}


def kernel_resources(report: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of a ``-Xptxas -v`` report, keyed by the (mangled) entry
    name: ``registers``, static shared memory ``smem_bytes`` (0 where the
    report names none: dynamic shared memory is not in it),
    ``stack_frame_bytes`` and ``spill_store_bytes`` / ``spill_load_bytes``."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {"smem_bytes": 0}
            continue
        if name is None:
            continue
        for field, pattern in _FIELDS.items():
            m = pattern.search(line)
            if m:
                out[name][field] = int(m.group(1))
    return out
