"""CLI: ``python -m video_features_tpu_torch feature_type=<family> key=value
...`` for the ported families (``registry.py``).

The JAX package's dotlist surface: the family's YAML defaults merged under
the ``key=value`` overrides, validated, then each video extracted under the
fault-tolerance runtime (``utils/faults.py``, ``utils/sinks.py
safe_extract``): ``retry_attempts`` tries with backoff, the per-video
``video_deadline_s`` watchdog, the decode ladder (each retry of a
``video_decode=parallel|process`` video demotes one rung), and for file
sinks the ``{output_path}/_failures.jsonl`` journal that quarantines POISON
videos on a rerun unless ``retry_failed=true``. An ``inject=`` plan (or
``VFT_INJECT``) is armed for the run, its summary printed at the end and
disarmed after (``utils/inject.py``). A failing video is reported
and the run goes on; as in the JAX CLI, the exit status is 0 whether or not
videos failed. Outputs: ``{output_path}/{feature_type}/{stem}_{key}.npy``
under ``save_numpy``.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

from .config import load_config, parse_dotlist, sanity_check, video_list
from .registry import get_extractor_cls
from .utils import inject
from .utils.faults import FailureJournal, RetryPolicy
from .utils.sinks import safe_extract


def main(argv: Optional[List[str]] = None) -> None:
    overrides = parse_dotlist(sys.argv[1:] if argv is None else argv)
    feature_type = overrides.get("feature_type")
    if not feature_type:
        raise ValueError("feature_type=... is required")
    cls = get_extractor_cls(feature_type)
    args = load_config(feature_type, overrides)
    sanity_check(args)
    plan = inject.arm_for_run(args.get("inject"))
    if plan is not None:
        print(f"inject: armed plan {plan.spec!r} (seed={plan.seed}; replay "
              "by re-running with this exact inject= string)")
    try:
        _run(cls(args), args)
    finally:
        if plan is not None:
            print(plan.summary())
        inject.disarm()  # in-process callers must not inherit the plan


def _run(extractor, args) -> None:
    policy = RetryPolicy.from_config(args)
    journal = (FailureJournal(args.output_path)
               if args.get("on_extraction", "print") != "print" else None)
    paths = video_list(args.get("video_paths"),
                       args.get("file_with_video_paths"))
    tally = {"done": 0, "skipped": 0, "error": 0, "quarantined": 0}
    failures: List[dict] = []
    t0 = time.perf_counter()
    for path in paths:
        tally[safe_extract(extractor._extract, path, policy=policy,
                           journal=journal,
                           decode_mode=extractor.video_decode,
                           on_terminal_failure=failures.append)] += 1
    summary = (f"{sum(tally.values())}/{len(paths)} videos in "
               f"{time.perf_counter() - t0:.1f}s: {tally['done']} extracted, "
               f"{tally['skipped']} already done, {tally['error']} failed")
    if tally["quarantined"]:
        summary += f", {tally['quarantined']} quarantined"
    print(summary)
    if failures and journal is not None:
        print(f"failure journal: {journal.path} (retry_failed=true re-runs "
              "quarantined videos)")
