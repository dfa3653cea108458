"""The port's install surface in ``pyproject.toml``.

- The port's ``package-data`` covers every file the port reads at run
  time: each non-``.py`` file of ``video_features_tpu_torch`` that the
  repository tracks matches one of its patterns (setuptools' glob
  semantics: ``*`` stays inside one path segment), and every pattern
  matches a tracked file. ``native/__init__.py`` reads
  ``native/vft_native.cpp`` to build the writer and ``lint/engine.py``
  reads ``lint/baseline.json``; an installed package without them could
  neither build the one nor lint.
- Its twelve ``vft-torch*`` commands resolve to callables of the port,
  clash with none of JAX's, and leave JAX's twelve and the required
  ``dependencies`` as they were; the ``torch`` extra names what the port
  imports beyond the standard library.
- Each command's ``--help`` exits 0 in a child that refuses jax, flax and
  video_features_tpu; the light ones import no torch.
- A wheel built offline from a copy of the tree carries both command sets,
  the extra and the port's data files.
- The kernels and the native writer build into the per-user cache where
  the package cannot be written; an attached compile-cache entry and
  ``set_build_dir`` come first."""
import fnmatch
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
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


# -- the install surface: console commands, the torch extra, the wheel -------

#: the JAX package's commands and required dependencies as the port found
#: them: the port's install surface adds to them and changes none
JAX_SCRIPTS = {
    "video_features_tpu": "video_features_tpu.cli:main",
    "vft-serve": "video_features_tpu.serve:main",
    "vft-gateway": "video_features_tpu.gateway:main",
    "vft-audit": "video_features_tpu.audit:main",
    "vft-fleet": "video_features_tpu.fleet_report:main",
    "vft-warmup": "video_features_tpu.compile_cache:warmup_main",
    "vft-roofline": "video_features_tpu.telemetry.roofline:report_main",
    "vft-alert": "video_features_tpu.telemetry.alerts:main",
    "vft-lint": "video_features_tpu.lint.engine:main",
    "vft-gc": "video_features_tpu.gc:main",
    "vft-loadgen": "video_features_tpu.loadgen:main",
    "vft-parity": "video_features_tpu.telemetry.parity:main",
}
JAX_DEPENDENCIES = ["jax>=0.4.34", "flax>=0.8", "numpy>=1.24",
                    "opencv-python-headless>=4.8", "pillow>=9", "pyyaml",
                    "regex", "tqdm"]
#: the port's commands that start without importing torch
LIGHT_COMMANDS = ("vft-torch", "vft-torch-gc", "vft-torch-audit",
                  "vft-torch-loadgen", "vft-torch-lint")
#: data files an installed port reads: the kernels' source, the native
#: writer's source, the lint's baseline
SHIPPED = ("video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
           "video_features_tpu_torch/native/vft_native.cpp",
           "video_features_tpu_torch/lint/baseline.json")


def project() -> dict:
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]


def port_scripts() -> dict:
    return {name: target for name, target in project()["scripts"].items()
            if target.startswith(PACKAGE + ".")}


def resolve(target: str):
    import importlib
    module, fn = target.split(":")
    return getattr(importlib.import_module(module), fn)


def test_port_commands_resolve_beside_jax_unchanged():
    scripts = project()["scripts"]
    port = port_scripts()
    assert {k: v for k, v in scripts.items() if k not in port} == JAX_SCRIPTS
    assert project()["dependencies"] == JAX_DEPENDENCIES
    assert len(port) == len(JAX_SCRIPTS) == 12
    assert not set(port) & set(JAX_SCRIPTS)
    assert all(name.startswith("vft-torch") for name in port)
    # one port command for each JAX command, on the module of its name
    jax_targets = {v.replace("video_features_tpu.", "") for v in
                   JAX_SCRIPTS.values() if not v.endswith("cli:main")}
    assert jax_targets <= {v.replace(PACKAGE + ".", "") for v in
                           port.values()}
    assert port["vft-torch"] == PACKAGE + ".__main__:main"
    for target in port.values():
        fn = resolve(target)
        assert callable(fn) and fn.__module__.startswith(PACKAGE)


def test_torch_extra_names_what_the_port_imports():
    extra = project()["optional-dependencies"]["torch"]
    names = {re.split(r"[<>=\[ ]", req)[0] for req in extra}
    assert names == {"torch", "numpy", "opencv-python-headless", "pillow",
                     "pyyaml", "regex", "scipy"}


_HELP = textwrap.dedent("""
    import contextlib, io, importlib, json, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "video_features_tpu"):
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    out = {}
    for name, target in json.loads(sys.argv[1]).items():
        module, fn = target.split(":")
        sys.argv = [name, "--help"]
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                code = getattr(importlib.import_module(module), fn)()
        except SystemExit as e:
            code = e.code
        out[name] = [code or 0, len(text.getvalue())]
    out["torch imported"] = "torch" in sys.modules
    print(json.dumps(out))
""")


def test_every_port_command_helps_without_jax():
    """Each port command's ``--help`` exits 0 and prints its usage, in two
    child processes that refuse jax, flax and video_features_tpu: one for
    the commands that start without torch (and import none), one for the
    rest."""
    port = port_scripts()
    light = {k: v for k, v in port.items() if k in LIGHT_COMMANDS}
    heavy = {k: v for k, v in port.items() if k not in LIGHT_COMMANDS}
    for group, torch_imported in ((light, False), (heavy, True)):
        proc = subprocess.run(
            [sys.executable, "-c", _HELP, json.dumps(group)], cwd=REPO,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        got = json.loads(proc.stdout.splitlines()[-1])
        assert got.pop("torch imported") is torch_imported
        assert set(got) == set(group)
        assert all(code == 0 and printed > 0
                   for code, printed in got.values()), got


def test_offline_wheel_ships_both_command_sets_and_the_extra(tmp_path):
    """A wheel built offline from a copy of the tree (no build/ or
    egg-info in the checkout): both sets of entry points, the ``torch``
    extra in its metadata, and the port's data files."""
    import zipfile
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("video_features_tpu", PACKAGE):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns(
            "_build", "__pycache__", "*.pyc"))
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-w", str(tmp_path / "dist"),
         str(src)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-2000:]
    wheel, = (tmp_path / "dist").glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        info = next(n.split("/")[0] for n in names
                    if n.endswith(".dist-info/METADATA"))
        entry_points = z.read(f"{info}/entry_points.txt").decode()
        metadata = z.read(f"{info}/METADATA").decode()
    commands = {line.split("=")[0].strip(): line.split("=", 1)[1].strip()
                for line in entry_points.splitlines() if "=" in line}
    assert {**JAX_SCRIPTS, **port_scripts()}.items() <= commands.items()
    assert "Provides-Extra: torch" in metadata
    assert re.search(r"Requires-Dist: torch>=2\.0; extra == .torch.",
                     metadata)
    assert all(path in names for path in SHIPPED)
    assert not [n for n in names if "/_build/" in n]


def test_build_dirs_fall_back_to_the_user_cache(tmp_path, monkeypatch):
    """Where the package's build directory cannot be written, the kernels
    and the native writer build under
    ``$XDG_CACHE_HOME/video_features_tpu_torch``; an attached compile-cache
    entry and ``set_build_dir`` still win; a writable directory keeps the
    build beside the sources."""
    from video_features_tpu_torch import compile_cache, native
    from video_features_tpu_torch.kernels import build
    site = tmp_path / "site"
    (site / "kernels").mkdir(parents=True)
    cache = tmp_path / "xdg"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    monkeypatch.setattr(build, "BUILD_DIR", site / "kernels" / "_build")
    monkeypatch.setattr(native, "BUILD_DIR", site / "native" / "_build")
    assert compile_cache.active() is None
    assert build.library_dir() == site / "kernels" / "_build"
    assert native.library_path().parent == site / "native" / "_build"
    (site / "native").mkdir()
    for d in (site / "kernels", site / "native", site):
        d.chmod(0o555)
    try:
        assert build.library_dir() == cache / PACKAGE / "kernels"
        assert build.library_path().parent == cache / PACKAGE / "kernels"
        assert native.library_path().parent == cache / PACKAGE / "native"
        build.set_build_dir(str(tmp_path / "named"))
        assert build.library_dir() == tmp_path / "named"
        build.set_build_dir(None)
        monkeypatch.setattr(compile_cache, "active",
                            lambda: type("Entry", (), {"dir": "/entry"}))
        assert build.library_dir() == Path("/entry")
        monkeypatch.undo()
        monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
        monkeypatch.setattr(native, "BUILD_DIR", site / "native" / "_build")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_failed", False)
        monkeypatch.delenv("VFT_NATIVE", raising=False)
        assert native.available()
        lib = native.library_path()
        assert lib.exists() and lib.parent == cache / PACKAGE / "native"
        assert not (site / "native" / "_build").exists()
    finally:
        build.set_build_dir(None)
        for d in (site, site / "kernels", site / "native"):
            d.chmod(0o755)
