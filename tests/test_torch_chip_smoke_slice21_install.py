"""chip_smoke.py's step 39 on the CPU at a small size: the checkout
installed from a copy of the tree, by ``pip`` (this interpreter has
``pip`` and ``setuptools``) and by the wheel's layout, made read-only, and
its ``vft-torch`` run on the telemetry slice with the install alone on
``PYTHONPATH`` and a fresh ``XDG_CACHE_HOME``; every other installed port
command's ``--help``. The script is imported without running ``main()``;
no lookup kernel runs on the CPU, so the kernels build nowhere and the
device trace holds no proj kernel here, while the native writer builds
under the fresh cache."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from video_features_tpu_torch import cli
from video_features_tpu_torch.utils.build_dirs import PACKAGE

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: the slice20 files' small sizes: one 10-frame stack, the RGB stream
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1, streams="rgb")
KEYS = {"install", "install_s", "package_file", "commands", "help_rc",
        "help_wall_s", "run_wall_s", "bit_equal_to_checkout", "stacks",
        "proj_kernels_in_trace", "built", "nvcc_s", "cache_libraries",
        "read_only_install", "roofline"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory, sample_video):
    """The checkout's run of the same slice, in process: the features the
    installed run must equal."""
    work = tmp_path_factory.mktemp("slice21_reference")
    cli.main(cs.telemetry_argv(str(work), sample_video, **SMALL))
    return work / "out" / "i3d"


@pytest.fixture(scope="module", params=["pip", "layout"])
def step(request, tmp_path_factory, sample_video, reference):
    work = tmp_path_factory.mktemp(f"slice21_{request.param}")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    # the installed run keeps this worker's share of the cores
    # (tests/test_torch_threads.py), as the in-process reference does: a
    # CPU convolution's sums follow its thread count, and the features are
    # held bit for bit
    mp.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    try:
        yield cs.installed_phase(video=sample_video, route=request.param,
                                 reference=str(reference), **SMALL)
    finally:
        mp.undo()


def test_installed_phase_runs_on_the_cpu(step):
    """The line's keys; the run through the install, bit-equal to the
    checkout's; every port command installed and its ``--help`` 0."""
    assert set(step) == KEYS
    assert step["install"] in ("pip", "layout")
    assert "/output/chip_smoke/install/site/" in step["package_file"]
    assert step["bit_equal_to_checkout"] and step["read_only_install"]
    assert len(step["commands"]) == 12 and "vft-torch" in step["commands"]
    assert step["help_rc"] == {name: 0 for name in step["commands"]}
    assert step["stacks"] == 1 and step["proj_kernels_in_trace"] == 0
    assert step["roofline"]["flops_total"] > 0
    assert step["roofline"]["dispatches"] == 1
    json.dumps(step)


def test_installed_port_builds_in_the_user_cache(step):
    """No kernel builds on the CPU; the native writer, which the install's
    read-only tree cannot hold, builds under the fresh cache."""
    assert "kernels" not in step["built"] and step["nvcc_s"] is None
    assert step["built"]["native"].startswith(
        str(Path(cs.INSTALL_ROOT).resolve() / "xdg" / PACKAGE
            / "native"))
    assert step["cache_libraries"] == [
        f"{PACKAGE}/native/{Path(step['built']['native']).name}"]


def test_install_routes_and_the_wheels_layout(tmp_path):
    """``pip`` where this interpreter has pip and setuptools; the layout
    route writes one wrapper a command of the parsed TOML."""
    import tomllib
    assert cs.install_route() == "pip"
    repo = Path(cs.__file__).resolve().parent
    with open(repo / "pyproject.toml", "rb") as f:
        toml = tomllib.load(f)
    src = tmp_path / "src"
    for pkg in cs.INSTALL_PACKAGES:
        (src / pkg / "native").mkdir(parents=True)
        (src / pkg / "__init__.py").write_text("")
        (src / pkg / "native" / "vft_native.cpp").write_text("")
        (src / pkg / "native" / "_build").mkdir()
        (src / pkg / "native" / "_build" / "x.so").write_text("")
    cs.lay_out(src, tmp_path / "site", toml["project"],
               toml["tool"]["setuptools"]["package-data"])
    bins = sorted(p.name for p in (tmp_path / "site" / "bin").iterdir())
    assert bins == sorted(toml["project"]["scripts"])
    assert (tmp_path / "site" / "video_features_tpu_torch" / "native" /
            "vft_native.cpp").exists()
    assert not list((tmp_path / "site").rglob("*.so"))
