"""Where the port builds its native libraries (the CUDA kernels of
``kernels/build.py`` and the ``.npy`` writer of ``native/``).

A checkout builds beside its sources, in a git-ignored ``_build/``. An
installed package often cannot: site-packages may be read-only to the user
who runs it. Then the build goes to a per-user cache,
``$XDG_CACHE_HOME/video_features_tpu_torch/<name>`` (``~/.cache`` when
the variable is unset). A directory whose mode grants no one write counts
as read-only even to root, who could write it anyway: an installer that
took the write bits off meant the tree to stay as it was shipped.
"""
from __future__ import annotations

import os
import stat
from pathlib import Path

PACKAGE = "video_features_tpu_torch"


def user_cache_dir(*parts: str) -> Path:
    """``$XDG_CACHE_HOME/video_features_tpu_torch/<parts>``, else under
    ``~/.cache``."""
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(root, PACKAGE, *parts)


def writable(path: Path) -> bool:
    """True when this process may create files in ``path``, or in its
    nearest existing parent when ``path`` is not made yet."""
    p = Path(path)
    while not p.exists():
        if p.parent == p:
            return False
        p = p.parent
    try:
        mode = os.stat(p).st_mode
    except OSError:
        return False
    return bool(stat.S_IMODE(mode) & 0o222) and os.access(
        p, os.W_OK | os.X_OK)


def build_dir(beside: Path, name: str) -> Path:
    """``beside`` (the build directory next to the sources) when it is
    writable, else :func:`user_cache_dir` ``(name)``."""
    return Path(beside) if writable(beside) else user_cache_dir(name)
