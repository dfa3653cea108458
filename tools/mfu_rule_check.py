"""The ``mfu_regression`` alert rule of both packages over retained history
files, on the CPU.

    python tools/mfu_rule_check.py DIR_OR_FILE [...]

Every ``_history_*.jsonl`` under the given paths (a run's output dir, or
history files brought back from a run on the card) is read with the port's
``telemetry/history.py read_history`` and judged by the port's and the JAX
package's ``_rule_mfu_regression`` at their default ``AlertConfig``, at the
time of the file's last sample. One JSON line per file: its samples, how
many carry an MFU for some family, each package's findings and whether they
are equal.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def check(path: Path) -> dict:
    from video_features_tpu.telemetry import alerts as jalerts
    from video_features_tpu_torch.telemetry import alerts as talerts
    from video_features_tpu_torch.telemetry import history

    series = list(history.jsonl.read_jsonl(path))
    obs = {"time": series[-1]["time"] if series else 0.0,
           "history": {"host": series}}
    port = talerts._rule_mfu_regression(obs, talerts.AlertConfig())
    jax = jalerts._rule_mfu_regression(obs, jalerts.AlertConfig())
    return {"file": str(path), "samples": len(series),
            "samples_with_mfu": sum(
                any(v is not None for v in (s.get("mfu") or {}).values())
                for s in series),
            "port": port, "jax": jax, "equal": port == jax}


def main(argv=None) -> int:
    paths = []
    for arg in (sys.argv[1:] if argv is None else argv):
        p = Path(arg)
        paths += ([p] if p.is_file()
                  else sorted(p.rglob("_history_*.jsonl")))
    for p in paths:
        print(json.dumps(check(p)))
    return 0 if paths else 1


if __name__ == "__main__":
    raise SystemExit(main())
