"""The port CLI's run loop against the JAX package's (tests/test_multihost.py):

- the hash shard is a partition, stable under reordering, equal to JAX's;
- the work list is shuffled as the JAX CLI shuffles it (``random.shuffle``
  of the given list: the same order under one seed), so that workers
  launched independently start on different videos;
- ``video_workers=2`` (threads over one mesh of 2 CPU replicas, resize on
  the card's side, two source resolutions through the per-device resizer
  cache) writes file for file what ``video_workers=1`` writes;
- ``video_workers=auto`` resolves to ``max(1, min(8, cores // 2))`` and
  ``print`` runs force 1, with JAX's warning;
- SIGTERM: the video in flight finishes, the rest are dropped, the run
  summary prints and the process exits 143.
"""
import os
import random
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu.parallel.mesh import \
    local_shard_of_list as jax_shard
from video_features_tpu.utils.lists import form_list_from_user_input
from video_features_tpu_torch import cli as tcli
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.parallel.mesh import local_shard_of_list

REPO = Path(__file__).resolve().parents[1]
VIDEOS = [f"/data/vid_{i:03d}.mp4" for i in range(57)]


def test_shard_partition_properties():
    shards = [local_shard_of_list(VIDEOS, host_id=h, num_hosts=4)
              for h in range(4)]
    assert sorted(v for s in shards for v in s) == sorted(VIDEOS)
    again = local_shard_of_list(list(reversed(VIDEOS)), host_id=2,
                                num_hosts=4)
    assert set(again) == set(shards[2])
    assert shards[2] == jax_shard(VIDEOS, host_id=2, num_hosts=4)
    assert local_shard_of_list(VIDEOS, host_id=0, num_hosts=1) == VIDEOS


class _Recorder:
    """An extractor stand-in that records the order it is handed videos."""
    video_decode = "inline"

    def __init__(self):
        self.seen = []

    def _extract(self, path):
        self.seen.append(path)
        return {}


def test_work_list_is_shuffled_as_jax_shuffles_it():
    paths = [f"v_{i:02d}.mp4" for i in range(20)]
    args = tconfig.Config({"video_paths": paths, "on_extraction": "print",
                           "retry_attempts": 1})
    rec = _Recorder()
    random.seed(3)
    tcli._run(rec, args)
    random.seed(3)
    want = form_list_from_user_input(paths, to_shuffle=True)
    assert rec.seen == want and rec.seen != paths


def test_video_workers_auto_and_print_force_one(capsys):
    assert tcli._video_workers("auto") == max(1, min(8, os.cpu_count() // 2))
    assert tcli._video_workers(3) == 3 and tcli._video_workers(None) == 1
    cfg = tconfig.load_config("resnet", {
        "device": "cpu", "video_workers": "auto", "video_paths": "x.mp4",
        "on_extraction": "print"})
    tconfig.sanity_check(cfg)
    assert cfg.video_workers == 1
    assert "forcing video_workers=1" in capsys.readouterr().out
    for bad in ("many", -2, True):
        cfg = tconfig.load_config("resnet", {
            "device": "cpu", "video_workers": bad, "video_paths": "x.mp4",
            "on_extraction": "save_numpy"})
        with pytest.raises(ValueError, match="video_workers"):
            tconfig.sanity_check(cfg)


def _write_clip(path: Path, frames: int, w: int, h: int, seed: int) -> str:
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                         (w, h))
    if not wr.isOpened():
        pytest.skip("cv2 cannot encode mp4v")
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for t in range(frames):
        frame = np.stack([127 + 120 * np.sin(xx / 9 + t / 5 + seed),
                          127 + 120 * np.sin(yy / 7 - t / 6),
                          127 + 120 * np.sin((xx + yy) / 11 + t / 4)], -1)
        wr.write(frame.clip(0, 255).astype(np.uint8))
    wr.release()
    return str(path)


def test_video_workers_threaded_matches_serial(tmp_path):
    vids = [_write_clip(tmp_path / "v_a.mp4", 9, 96, 72, 0),
            _write_clip(tmp_path / "v_b.mp4", 7, 80, 64, 1)]

    def run(out, workers):
        tcli.main([
            "feature_type=resnet", "model_name=resnet18", "device=cpu",
            "batch_size=4", "allow_random_weights=true", "resize=device",
            "mesh_devices=2", f"video_workers={workers}",
            "on_extraction=save_numpy", f"output_path={out}",
            f"tmp_path={tmp_path / 'tmp'}",
            "video_paths=[" + ",".join(vids) + "]"])
        return {p.name: np.load(p)
                for p in sorted((out / "resnet" / "resnet18").glob("*.npy"))}

    serial = run(tmp_path / "serial", 1)
    threaded = run(tmp_path / "threaded", 2)
    assert serial.keys() == threaded.keys() and len(serial) == 6
    for name in serial:
        np.testing.assert_array_equal(serial[name], threaded[name],
                                      err_msg=name)


def test_sigterm_drains_and_exits_143(sample_video, tmp_path):
    vids = []
    for i in range(5):
        v = tmp_path / f"v_pre_{i}.mp4"
        shutil.copy(sample_video, v)
        vids.append(str(v))
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "video_features_tpu_torch",
           "feature_type=resnet", "model_name=resnet18", "device=cpu",
           "batch_size=8", "extraction_fps=2", "allow_random_weights=true",
           "on_extraction=save_numpy", f"output_path={out}",
           f"tmp_path={tmp_path / 'tmp'}", f"video_paths=[{','.join(vids)}]"]
    # two threads: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    log_path = tmp_path / "worker.log"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while not list(out.rglob("*_resnet.npy")):
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(log_path.read_text()[-2000:])
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    assert proc.returncode == 143, text[-2000:]
    assert "SIGTERM: finishing in-flight" in text
    assert "videos in" in text and "failed" in text  # the summary
    done = list(out.rglob("*_resnet.npy"))
    assert 0 < len(done) < len(vids), text[-2000:]
    for p in out.rglob("*.npy"):
        np.load(p)  # complete, loadable
