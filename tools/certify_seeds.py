"""RAFT's bfloat16 certify verdict over several seeded weight draws, in the
port and in the JAX package, on the CPU.

    python tools/certify_seeds.py --out DIR [--seeds 0 1 2 3] [--jax]

For each seed, the port's seeded RAFT (``weights/bridge.py seeded_init_``,
the draw the raft family makes with ``allow_random_weights=true`` at
``SEED_RAFT``) is written to ``DIR/raft_seed{n}.pt`` and certified with
``python -m video_features_tpu_torch parity certify --family raft --flip
dtype=bf16`` at the YAML defaults over the vendored sample; with ``--jax``
the JAX package's ``python main.py parity certify`` runs on the same
checkpoint, and once on its own seeded weights. One JSON line per run:
package, seed, verdict, first drifted seam, and the backbone seam's max abs
and cosine. Each run is two RAFT arms of 20 iterations on 5 pairs at
240x320: one to two minutes on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _certify(cmd, out: Path, env: dict) -> dict:
    subprocess.run(cmd, cwd=REPO, env=env, check=False,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    doc = json.loads((out / "_parity_verdict.json").read_text())
    b = doc["seams"]["backbone"]
    return {"verdict": doc["verdict"], "first_drift": doc["first_drift"],
            "backbone_max_abs": b["max_abs"], "backbone_cos": b["cos"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--jax", action="store_true",
                    help="also certify in the JAX package")
    a = ap.parse_args(argv)
    import torch

    from video_features_tpu_torch.models import raft as traft
    from video_features_tpu_torch.weights.bridge import seeded_init_

    root = Path(a.out).resolve()
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               VFT_WEIGHTS_DIR=str(root / "weights"))
    runs = []
    for seed in a.seeds:
        ckpt = root / f"raft_seed{seed}.pt"
        torch.save(seeded_init_(traft.RAFT(), seed).state_dict(), ckpt)
        out = root / f"port_seed{seed}"
        runs.append(("port", seed, out, [
            sys.executable, "-m", "video_features_tpu_torch", "parity",
            "certify", "--family", "raft", "--flip", "dtype=bf16", "--out",
            str(out), "--set", "device=cpu", "--set",
            f"weights_path={ckpt}"]))
        if a.jax:
            out = root / f"jax_seed{seed}"
            runs.append(("jax", seed, out, [
                sys.executable, "main.py", "parity", "certify", "--family",
                "raft", "--flip", "dtype=bf16", "--out", str(out), "--set",
                "device=cpu", "--set", f"weights_path={ckpt}"]))
    if a.jax:
        out = root / "jax_own"
        runs.append(("jax", "own", out, [
            sys.executable, "main.py", "parity", "certify", "--family",
            "raft", "--flip", "dtype=bf16", "--out", str(out), "--set",
            "device=cpu"]))
    for package, seed, out, cmd in runs:
        print(json.dumps({"package": package, "seed": seed,
                          **_certify(cmd, out, env)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
