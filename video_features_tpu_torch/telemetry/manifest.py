"""Run manifest: ``{output_path}/_run.json``, written once at exit (port of
``video_features_tpu/telemetry/manifest.py``).

The manifest makes a run auditable from its artifacts alone: the config it
ran with, the code (git commit and the versions of torch, CUDA, cuDNN and
the host libraries), the hardware it saw (``parallel/mesh.py
mesh_topology`` and the card's name), and what it did (tally, per-stage
totals, the metrics dump, the health roll-up, and with ``roofline=true``
the final per-family MFU summary of ``telemetry/roofline.py``). Written by
atomic replace (``telemetry/jsonl.py``), so a preempted exit never leaves a
torn document. The ``compile_cache`` field carries the kernel build's
hits and misses and the attached compile-cache entry, in the JAX
manifest's shape (``compile_cache.py section``).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, Optional

MANIFEST_SCHEMA_VERSION = "vft.run_manifest/1"
MANIFEST_FILENAME = "_run.json"


def _git_describe(cwd: Optional[str] = None) -> Dict[str, Any]:
    """Best-effort commit and dirty flag; outside a checkout (an installed
    package, a copied tree) ``unknown`` rather than a failed run."""
    try:
        root = cwd or os.path.dirname(os.path.abspath(__file__))
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=5)
        if rev.returncode != 0:
            return {"commit": "unknown"}
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=root, capture_output=True,
            text=True, timeout=5)
        return {"commit": rev.stdout.strip(),
                "dirty": bool(dirty.stdout.strip())
                if dirty.returncode == 0 else None}
    except Exception:
        return {"commit": "unknown"}


def _versions() -> Dict[str, str]:
    """Python, torch with the CUDA and cuDNN it was built for, and the host
    libraries the run may import (``absent`` where one is missing)."""
    import torch
    out = {"python": sys.version.split()[0], "torch": torch.__version__,
           "torch_cuda": str(torch.version.cuda),
           "cudnn": str(torch.backends.cudnn.version())}
    for mod in ("numpy", "cv2", "yaml"):
        try:
            m = __import__(mod)
            out[mod] = str(getattr(m, "__version__", "?"))
        except Exception:
            out[mod] = "absent"
    return out


def _topology() -> Dict[str, Any]:
    """``mesh_topology()`` plus ``device_name``, the first card's name
    (None on the CPU); an error note rather than no manifest when the
    backend is torn down."""
    try:
        import torch

        from ..parallel.mesh import mesh_topology
        topo = mesh_topology()
        topo["device_name"] = (torch.cuda.get_device_name(0)
                               if torch.cuda.is_available() else None)
        return topo
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def build_manifest(*,
                   run_config: Optional[dict] = None,
                   feature_type: Optional[str] = None,
                   host_id: Optional[str] = None,
                   run_id: Optional[str] = None,
                   started_time: Optional[float] = None,
                   wall_s: Optional[float] = None,
                   tally: Optional[Dict[str, int]] = None,
                   failure_tallies: Optional[Dict[str, int]] = None,
                   stage_totals: Optional[Dict[str, Any]] = None,
                   metrics_dump: Optional[dict] = None,
                   health: Optional[Dict[str, Dict[str, int]]] = None,
                   roofline: Optional[dict] = None,
                   compile_cache: Optional[dict] = None,
                   ) -> dict:
    done = (tally or {}).get("done", 0)
    return {
        "schema": MANIFEST_SCHEMA_VERSION,
        "feature_type": feature_type,
        "host": socket.gethostname(),
        "host_id": host_id,
        # matches the run_id of this run's heartbeats; report tools use it
        # to ignore stale heartbeat files of an earlier run of the same dir
        "run_id": run_id,
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "started_time": started_time,
        "finished_time": round(time.time(), 3),
        "wall_s": None if wall_s is None else round(float(wall_s), 3),
        "videos_per_s": (round(done / wall_s, 4)
                         if wall_s and done else None),
        "tally": dict(tally or {}),
        "failure_tallies": dict(failure_tallies or {}),
        "stage_totals": dict(stage_totals or {}),
        "compile_cache": dict(compile_cache or {}),
        # output-health roll-up (telemetry/health.py): per-family records
        # and NaN/Inf totals; {} when health=false
        "health": dict(health or {}),
        # the run's final per-family MFU and verdict document; {} when
        # roofline=false
        "roofline": dict(roofline or {}),
        "config": dict(run_config or {}),
        "versions": _versions(),
        "git": _git_describe(),
        "topology": _topology(),
        "metrics": metrics_dump or {"series": []},
    }
