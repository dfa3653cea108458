"""The CLI at the PWC paths' YAML defaults (``feature_type=i3d``, whose
``flow_type`` is pwc, and ``feature_type=pwc``), cut short: split from
tests/test_torch_pwc.py, whose module fixtures (the JAX and port PWC and
I3D PWC runs) and these two CLI subprocesses held one xdist worker near
240 s under ``--dist loadfile``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("family", ["i3d", "pwc"])
def test_cli_defaults_write_outputs(sample_video, tmp_path, family):
    """``python -m video_features_tpu_torch`` at the family's YAML defaults
    (i3d: ``flow_type=pwc``, float32; pwc: bfloat16), cut short, writes
    ``{stem}_{key}.npy``."""
    cut = (["stack_size=10", "step_size=10", "extraction_fps=1"]
           if family == "i3d" else ["extraction_total=4", "side_size=64"])
    cmd = [sys.executable, "-m", "video_features_tpu_torch",
           f"feature_type={family}", "device=cpu",
           "allow_random_weights=true", *cut, "on_extraction=save_numpy",
           f"output_path={tmp_path / 'out'}", f"tmp_path={tmp_path / 'tmp'}",
           f"video_paths={sample_video}"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    stem = Path(sample_video).stem
    out = tmp_path / "out" / family
    keys = ["rgb", "flow"] if family == "i3d" else ["pwc"]
    for key in keys + ["fps", "timestamps_ms"]:
        assert (out / f"{stem}_{key}.npy").exists(), key
    if family == "i3d":
        assert np.load(out / f"{stem}_flow.npy").shape == (1, 1024)
    else:
        flow = np.load(out / f"{stem}_pwc.npy")
        assert flow.shape == (3, 2, 64, 85) and np.isfinite(flow).all()
