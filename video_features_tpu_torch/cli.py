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

Scale-out, as in the JAX CLI: the work list is shuffled, so that workers
launched independently start on different videos; ``distributed=true``
joins ``torch.distributed`` (gloo, ``env://``: torchrun's
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``; only the
work list is shared, no tensor crosses processes) and keeps this process's
shard (``parallel/mesh.py local_shard_of_list``), one process per host
with the mesh over that host's cards; ``video_workers`` videos run at once
on threads feeding the mesh. On SIGTERM the videos in flight finish, the
rest are dropped and the process exits 143; a rerun resumes through the
skip of finished outputs.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import List, Optional

from .config import load_config, parse_dotlist, sanity_check, video_list
from .parallel.mesh import local_shard_of_list
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
    _maybe_init_distributed(args)
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


def _maybe_init_distributed(args) -> None:
    """``distributed=true``: join the process group that torchrun's
    environment describes, unless this process is already in one (a
    launcher, or an earlier in-process run)."""
    if not args.get("distributed"):
        return
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(backend="gloo", init_method="env://")
    print(f"distributed: rank {dist.get_rank()} of "
          f"{dist.get_world_size()}")


def _video_workers(value) -> int:
    """``video_workers`` as a thread count: ``auto`` is
    ``max(1, min(8, cores // 2))`` (threads past the cores only contend)."""
    if value == "auto":
        return max(1, min(8, (os.cpu_count() or 1) // 2))
    return int(value or 1)


def _run(extractor, args) -> None:
    policy = RetryPolicy.from_config(args)
    journal = (FailureJournal(args.output_path)
               if args.get("on_extraction", "print") != "print" else None)
    paths = local_shard_of_list(video_list(
        args.get("video_paths"), args.get("file_with_video_paths"),
        shuffle=True))
    workers = _video_workers(args.get("video_workers"))
    tally = {"done": 0, "skipped": 0, "error": 0, "quarantined": 0}
    failures: List[dict] = []
    lock = threading.Lock()

    def on_failure(record: dict) -> None:
        with lock:
            failures.append(record)

    # preemption: finish the videos in flight (atomic writes and the skip
    # of finished outputs make a restarted worker resume), drop the rest
    stop = threading.Event()
    in_main = threading.current_thread() is threading.main_thread()
    prev_handler = None
    if in_main:
        def on_sigterm(signo, frame):
            print("SIGTERM: finishing in-flight video(s), dropping the rest")
            stop.set()
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)

    def run_one(path: str) -> None:
        if stop.is_set():
            return
        status = safe_extract(extractor._extract, path, policy=policy,
                              journal=journal,
                              decode_mode=extractor.video_decode,
                              on_terminal_failure=on_failure)
        with lock:
            tally[status] += 1

    t0 = time.perf_counter()
    try:
        if workers <= 1:
            for path in paths:
                if stop.is_set():
                    break
                run_one(path)
        else:
            # the host side (decode, transform) of up to video_workers
            # videos on threads feeding the mesh; each video keeps its own
            # stream order and its own fault isolation
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="vft-video") as pool:
                futures = [pool.submit(run_one, p) for p in paths]
                try:
                    for fut in as_completed(futures):
                        fut.result()
                except BaseException:
                    pool.shutdown(cancel_futures=True)
                    raise
    finally:
        # None: a handler installed from C, which signal() cannot restore
        if in_main and prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    summary = (f"{sum(tally.values())}/{len(paths)} videos in "
               f"{time.perf_counter() - t0:.1f}s: {tally['done']} extracted, "
               f"{tally['skipped']} already done, {tally['error']} failed")
    if tally["quarantined"]:
        summary += f", {tally['quarantined']} quarantined"
    print(summary)
    if failures and journal is not None:
        print(f"failure journal: {journal.path} (retry_failed=true re-runs "
              "quarantined videos)")
    if stop.is_set():
        raise SystemExit(143)  # the conventional SIGTERM status
