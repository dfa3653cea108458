"""Two real processes run the port CLI with ``distributed=true``
(tests/test_distributed.py's check, on the port): each joins one
``torch.distributed`` gloo group from ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK`` and ``WORLD_SIZE`` (torchrun's variables), extracts resnet18
features of its shard of 6 short videos into ONE shared output directory
and exits 0. Every video is written exactly once; each worker's shard,
read from the live group after the run, is the one ``local_shard_of_list``
predicts (and JAX's hash gives), and its own outputs exist before it exits.
Logs go to files, never pipes (an undrained pipe can block a worker).
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu.parallel.mesh import \
    local_shard_of_list as jax_shard
from video_features_tpu_torch.parallel.mesh import local_shard_of_list

REPO = Path(__file__).resolve().parents[1]
N_VIDEOS = 6
TIMEOUT_S = 240

_WORKER = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    from video_features_tpu_torch.cli import main
    main(["feature_type=resnet", "model_name=resnet18", "device=cpu",
          "distributed=true", "allow_random_weights=true", "batch_size=16",
          "on_extraction=save_numpy", "output_path={out}",
          "tmp_path={tmp}", "file_with_video_paths={listfile}"])
    import torch.distributed as dist
    from video_features_tpu_torch.parallel.mesh import local_shard_of_list
    videos = Path({listfile!r}).read_text().split()
    mine = local_shard_of_list(videos)
    for v in mine:
        f = Path({out!r}) / "resnet" / "resnet18" / (Path(v).stem
                                                    + "_resnet.npy")
        assert f.exists(), f
    print("SHARD", dist.get_rank(), ",".join(sorted(Path(v).stem
                                                    for v in mine)))
    print("WORKER_DONE", dist.get_rank(), dist.get_world_size())
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_clip(path: Path, seed: int) -> str:
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                        (64, 48))
    if not w.isOpened():
        pytest.skip("cv2 cannot encode mp4v")
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    for t in range(5):
        frame = np.stack([127 + 120 * np.sin(xx / 9 + t / 5 + seed),
                          127 + 120 * np.sin(yy / 7 - t / 6),
                          127 + 120 * np.sin((xx + yy) / 11 + t)], -1)
        w.write(frame.clip(0, 255).astype(np.uint8))
    w.release()
    return str(path)


def test_two_process_distributed_extraction(tmp_path):
    videos = [_write_clip(tmp_path / f"v_dist_{i:03d}.mp4", i)
              for i in range(N_VIDEOS)]
    listfile = tmp_path / "videos.txt"
    listfile.write_text("\n".join(videos) + "\n")
    shards = [local_shard_of_list(videos, host_id=i, num_hosts=2)
              for i in range(2)]
    assert shards == [jax_shard(videos, host_id=i, num_hosts=2)
                      for i in range(2)]
    assert sorted(shards[0] + shards[1]) == sorted(videos)
    assert shards[0] and shards[1]  # rename the copies if this trips

    out = tmp_path / "out"
    # two threads each: the suite's other workers share the cores
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="2")
    procs, logs = [], []
    try:
        for rank in range(2):
            script = _WORKER.format(repo=str(REPO), out=str(out),
                                    tmp=str(tmp_path / f"wtmp_{rank}"),
                                    listfile=str(listfile))
            log = open(tmp_path / f"worker_{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], stdout=log,
                stderr=subprocess.STDOUT, env=dict(env, RANK=str(rank))))
        for p in procs:
            assert p.wait(timeout=TIMEOUT_S) == 0, _tail(tmp_path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()

    feat_dir = out / "resnet" / "resnet18"
    assert sorted(p.name for p in feat_dir.glob("*_resnet.npy")) == sorted(
        Path(v).stem + "_resnet.npy" for v in videos)
    for v in videos:
        arr = np.load(feat_dir / f"{Path(v).stem}_resnet.npy")
        assert arr.shape == (5, 512)
    for rank in range(2):
        text = (tmp_path / f"worker_{rank}.log").read_text()
        assert f"WORKER_DONE {rank} 2" in text, text[-2000:]
        want = ",".join(sorted(Path(v).stem for v in shards[rank]))
        assert f"SHARD {rank} {want}" in text, (want, text[-2000:])
        # each worker extracted its shard only
        assert f"{len(shards[rank])} extracted" in text, text[-2000:]


def _tail(tmp_path):
    return "\n".join(
        f"--- worker {i} ---\n"
        + (tmp_path / f"worker_{i}.log").read_text()[-1500:]
        for i in range(2))
