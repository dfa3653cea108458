"""The port's ``package-data`` in ``pyproject.toml`` covers every file the
port reads at run time: each non-``.py`` file of ``video_features_tpu_torch``
that the repository tracks matches one of its patterns (setuptools' glob
semantics: ``*`` stays inside one path segment), and every pattern matches
a tracked file. ``native/__init__.py`` reads ``native/vft_native.cpp`` to
build the writer and ``lint/engine.py`` reads ``lint/baseline.json``; an
installed package without them could neither build the one nor lint."""
import fnmatch
import os
import subprocess
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "video_features_tpu_torch"
#: directories the port writes at run time, never shipped (``.gitignore``)
BUILD_DIRS = {"_build", "__pycache__"}


def package_data() -> list:
    with open(REPO / "pyproject.toml", "rb") as f:
        doc = tomllib.load(f)
    return doc["tool"]["setuptools"]["package-data"][PACKAGE]


def tracked_data_files() -> list:
    """The port's tracked non-``.py`` files, relative to the package: from
    ``git ls-files`` in a checkout, else from a walk of a tree without its
    history that skips the run-time build directories."""
    root = REPO / PACKAGE
    try:
        out = subprocess.run(["git", "ls-files", "--", PACKAGE], cwd=REPO,
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.split()
        files = [str(Path(p).relative_to(PACKAGE)) for p in out]
    except (OSError, subprocess.CalledProcessError):
        files = [str(Path(d, f).relative_to(root))
                 for d, dirs, names in os.walk(root)
                 for f in names if not (set(Path(d).parts) & BUILD_DIRS)]
    return sorted(f for f in files
                  if not f.endswith((".py", ".pyc")) and
                  not (set(Path(f).parts) & BUILD_DIRS))


def matches(path: str, pattern: str) -> bool:
    """``path`` under ``pattern`` as setuptools globs it: segment by
    segment, so ``kernels/csrc/*`` takes no file of a subdirectory."""
    parts, pats = Path(path).parts, Path(pattern).parts
    return len(parts) == len(pats) and all(
        fnmatch.fnmatchcase(a, b) for a, b in zip(parts, pats))


def uncovered(files, patterns) -> list:
    return [f for f in files if not any(matches(f, p) for p in patterns)]


def test_package_data_covers_every_tracked_data_file():
    files = tracked_data_files()
    patterns = package_data()
    assert "native/vft_native.cpp" in files and "lint/baseline.json" in files
    assert uncovered(files, patterns) == []
    assert [p for p in patterns
            if not any(matches(f, p) for f in files)] == []


@pytest.mark.parametrize("pattern, path, want", [
    ("kernels/csrc/*", "kernels/csrc/corr_lookup.cu", True),
    ("kernels/csrc/*", "kernels/csrc/sub/x.cu", False),
    ("configs/*.yml", "configs/i3d.yml", True),
    ("configs/*.yml", "extra/configs/i3d.yml", False),
    ("lint/baseline.json", "lint/baseline.json", True),
])
def test_patterns_glob_one_segment_at_a_time(pattern, path, want):
    assert matches(path, pattern) is want


def test_the_earlier_patterns_missed_the_writer_and_the_baseline():
    """The patterns before ``native/*.cpp`` and ``lint/baseline.json``
    joined them left exactly those two files out."""
    earlier = [p for p in package_data()
               if p not in ("native/*.cpp", "lint/baseline.json")]
    assert uncovered(tracked_data_files(), earlier) == [
        "lint/baseline.json", "native/vft_native.cpp"]
