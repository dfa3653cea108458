"""CLI: ``python -m video_features_tpu_torch feature_type=<family> key=value
...`` for the ported families (``registry.py``), or
``feature_type=<family>,<family>,...`` for several families over one decode
of each video (``extractors/multi.py``: top-level keys are shared,
``<family>.key=value`` is one family's own; each family writes under its
own namespaced output directory, and the summary counts (video, family)
units with one line per family).

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

The run plane, as in the JAX CLI (each off by default): ``telemetry=true``
writes ``_telemetry.jsonl`` (one span per video, or per (video, family)),
``_heartbeat_{host_id}.json`` every ``metrics_interval_s`` and ``_run.json``
at exit; ``trace=true`` the host pipeline's timeline ``_trace.json``; both
under the run's output root (``{output_path}/{feature_type}[/model_name]``,
or the given ``output_path`` of a multi-family run). ``health=true``
digests every output into the family's ``{output_path}/_health.jsonl`` and
quarantines non-finite ones. ``profile=true`` prints the per-stage
breakdown (decode, h2d, forward, write, health) at the end;
``profile_trace_dir=DIR`` captures a ``torch.profiler`` trace of the run
into DIR (``utils/profiling.py``). ``roofline=true`` writes the MFU
accounting ``_roofline.json`` under the run's output root at exit
(``telemetry/roofline.py``); ``parity=true`` appends per-seam numerics
digests to ``_parity.jsonl`` there (``telemetry/parity.py``).
``history=true`` appends a sample of every heartbeat to
``_history_{host_id}.jsonl`` (``telemetry/history.py``); ``alerts=true``
(which implies ``history``) evaluates the alert rules on every heartbeat,
journals their transitions to ``_alerts.jsonl`` and captures an incident
bundle under ``_incidents/`` when one fires (``telemetry/alerts.py``); both
need ``telemetry=true``. ``gc=true`` adds the storage accounting: a
heartbeat ``gc`` section and the ``vft_gc_*`` gauges (``gc.py
GcMonitor``). The run's report is ``python -m
video_features_tpu_torch.telemetry.report OUT``, a fleet's ``python -m
video_features_tpu_torch.fleet_report ROOT`` (``--stitch`` merges the
hosts' traces) and the alert evaluator's ``python -m
video_features_tpu_torch.telemetry.alerts ROOT``.

The serving plane, as in the JAX CLI: the compile cache
(``compile_cache.py``) is attached before the extractor is built, so the
kernel library comes from the fleet-shared store or is built into it, and
the entry is sealed at exit; ``compilation_cache_dir`` names the
per-machine build directory. ``fleet=queue`` (with ``telemetry=true``)
drains the shared work-stealing queue under ``{output root}/_queue/``
(``parallel/queue.py``) instead of keeping a static shard: every host seeds
the full list, claims one video at a time, renews its leases from the
heartbeat (its ``fleet`` section) and steals expired ones, and sweeps
``.staging/`` orphans back to pending after ``gc_staging_retention_s``
when set; ``fleet_canary=true`` gates a joining host on a re-extracted
slice of done work.

Subcommands: ``python -m video_features_tpu_torch serve feature_type=...
spool_dir=...`` runs the warm server over a file spool (``serve.py``);
``... gateway spool_dir=...`` the HTTP front door (``gateway.py``);
``... warmup <family> [key=value ...]`` builds and seals a compile-cache
entry ahead of time; ``... parity <run_dir>`` summarizes a run's
``_parity.jsonl``, and ``... parity certify --family raft --flip dtype=bf16
device=cuda`` A/B-certifies a numerics flip into ``_parity_verdict.json``
(``--out``, default the working directory); ``... gc <root>`` accounts
the storage planes and runs a journaled eviction sweep (``gc.py``);
``... audit <root>`` checks a tree's durability invariants (``audit.py``);
``... loadgen SCENARIO.yml --spool ... --base-url ...`` drives a seeded
traffic drill through the gateway (``loadgen.py``), and ``... compare A B``
diffs two runs' digests, stages, failures and artifacts into one verdict
(``compare_runs.py``); ``... lint [--json] [--baseline ...]`` runs vft-lint
over the port (``lint/``).
"""
from __future__ import annotations

import os
import signal
import socket
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, List, Optional

from . import compile_cache
from .config import (Config, load_config, load_multi_config, parse_dotlist,
                     sanity_check, sanity_check_multi, video_list)
from .parallel.mesh import _rank_and_world, local_shard_of_list
from .registry import get_extractor_cls, parse_feature_types
from .telemetry import NOOP_SPAN
from .utils import inject
from .utils.faults import FailureJournal, RetryPolicy
from .utils.profiling import TraceCapture, profiler
from .utils.sinks import safe_extract


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "parity":
        from .telemetry.parity import main as parity_main
        raise SystemExit(parity_main(argv[1:]))
    if argv and argv[0] == "serve":
        from .serve import serve_main
        return serve_main(argv[1:])
    if argv and argv[0] == "gateway":
        from .gateway import gateway_main
        return gateway_main(argv[1:])
    if argv and argv[0] == "warmup":
        return compile_cache.warmup_main(argv[1:])
    if argv and argv[0] == "gc":
        from .gc import main as gc_main
        raise SystemExit(gc_main(argv[1:]))
    if argv and argv[0] == "audit":
        from .audit import main as audit_main
        raise SystemExit(audit_main(argv[1:]))
    if argv and argv[0] == "loadgen":
        from .loadgen import loadgen_main
        raise SystemExit(loadgen_main(argv[1:]))
    if argv and argv[0] == "compare":
        from .compare_runs import main as compare_main
        raise SystemExit(compare_main(argv[1:]))
    if argv and argv[0] == "lint":
        from .lint.engine import main as lint_main
        raise SystemExit(lint_main(argv[1:]))
    overrides = parse_dotlist(argv)
    feature_type = overrides.get("feature_type")
    if not feature_type:
        raise ValueError("feature_type=... is required")
    families = parse_feature_types(feature_type)
    if len(families) > 1:
        # per-family configs (top-level keys shared, `family.key=` a
        # family's own), one shared decode per video (extractors/multi.py)
        per_family = load_multi_config(families, overrides)
        args = per_family[families[0]]
        # the run's own artifacts live at the given root; sanity_check
        # namespaces each family's sinks and journal under it
        out_root = str(args.output_path)
        _maybe_init_distributed(args)
        sanity_check_multi(per_family)
    else:
        per_family = None
        args = load_config(families[0], overrides)
        sanity_check(args)
        out_root = str(args.output_path)
        _maybe_init_distributed(args)
    plan = inject.arm_for_run(args.get("inject"))
    if plan is not None:
        print(f"inject: armed plan {plan.spec!r} (seed={plan.seed}; replay "
              "by re-running with this exact inject= string)")
    run_label = ",".join(families)
    # the compile cache, before the extractor exists: its kernel library
    # comes from the entry (verified on attach) or is built into it
    compile_cache.configure_build_dir(args)
    cc_baseline = compile_cache.snapshot()
    cc_entry = (compile_cache.attach_for_multi_args(per_family)
                if per_family is not None
                else compile_cache.attach_for_args(families[0], args))
    if cc_entry is not None:
        print(f"compile cache: entry {cc_entry.key[:12]} "
              f"({'warm' if cc_entry.warm_at_attach else 'cold'}, "
              f"{cc_entry.verified} verified"
              + (f", {cc_entry.dropped} dropped" if cc_entry.dropped else "")
              + f") at {cc_entry.dir}")
    fleet_host = (recorder_host_id(args)
                  if _fleet_mode(args) == "queue" else None)
    recorder = tracer = rf_observer = parity_observer = alert_engine = None
    tally = _new_tally()
    failures: List[dict] = []
    n_paths = 0
    try:
        if per_family is not None:
            from .extractors.multi import MultiExtractor
            extractor = MultiExtractor(per_family)
            run = _run_multi
        else:
            extractor = get_extractor_cls(families[0])(args)
            run = _run
        # the profiler is process-global: an in-process rerun starts afresh
        profiler.enabled = bool(args.get("profile"))
        profiler.reset()
        recorder = _new_recorder(args, per_family, out_root, run_label,
                                 host_id=fleet_host,
                                 cc_baseline=cc_baseline)
        if recorder is not None:
            # both hooks before start(): the first heartbeat seeds the
            # windows the rules diff, which short runs need to alert at all
            if args.get("history") or args.get("alerts"):
                from .telemetry.history import HistoryWriter
                HistoryWriter(out_root, recorder.host_id).attach(recorder)
            if args.get("alerts"):
                from .telemetry.alerts import AlertEngine
                alert_engine = AlertEngine(
                    out_root, run_id=recorder.run_id).attach(recorder)
            # gc=true: the heartbeat's gc section and the vft_gc_* gauges
            # (accounting only; eviction is the gc command's)
            if args.get("gc"):
                from .gc import GcConfig, GcMonitor
                GcMonitor(out_root, GcConfig.from_args(args)).attach(
                    recorder)
            recorder.start()
        # fleet=queue workers co-own out_root: each writes its own
        # _trace_/_roofline_/_parity_{host_id} file
        if args.get("trace"):
            from .telemetry.trace import TraceRecorder
            tracer = TraceRecorder(out_root, host_id=fleet_host).start()
        # after the recorder: the observer chains onto its stage hook
        if args.get("roofline"):
            from .telemetry.roofline import RooflineObserver
            rf_observer = RooflineObserver(
                out_root, default_family=run_label,
                run_id=(recorder.run_id if recorder is not None
                        else None), host_id=fleet_host).start()
        if args.get("parity"):
            from .telemetry import parity
            parity_observer = parity.ParityObserver(out_root,
                                                    host_id=fleet_host)
            parity._set_active(parity_observer)
        with TraceCapture(args.get("profile_trace_dir")) as capture:
            n_paths = run(extractor, args, recorder, tally, failures)
    finally:
        if recorder is not None:
            # in the finally: an aborted run still leaves its manifest and
            # final heartbeat, which is what its abort is debugged with
            by_cat: dict = {}
            for rec in failures:
                cat = rec.get("category") or "?"
                by_cat[cat] = by_cat.get(cat, 0) + 1
            # summarized before the recorder closes, so the manifest and
            # the final heartbeat carry the end-of-run MFU and verdicts
            rf_summary = None
            if rf_observer is not None:
                try:
                    rf_summary = rf_observer.summary(resolve_peak=True)
                except Exception:
                    rf_summary = None
            recorder.close(tally=dict(tally), failure_tallies=by_cat,
                           roofline=rf_summary)
        if rf_observer is not None:
            # after the recorder: it restores the stage hook only if still
            # its own, and writes _roofline.json atomically
            rf_observer.close()
        if tracer is not None:
            tracer.close()  # a complete trace file, aborted run or not
        if parity_observer is not None:
            # the appends are durable already; detach the global so that
            # in-process callers do not inherit the taps
            from .telemetry import parity
            if parity.active() is parity_observer:
                parity._set_active(None)
            parity_observer.close()
        if plan is not None:
            print(plan.summary())
        inject.disarm()  # in-process callers must not inherit the plan
        profiler.enabled = False
        # sealed even on an aborted run: a library nvcc finished is
        # complete (its write is a rename), and sealing it saves the next
        # host the build
        compile_cache.seal_active()
    if recorder is not None:
        print(f"telemetry: {recorder.manifest_path} + {recorder.spans_path} "
              f"(render with python -m "
              f"video_features_tpu_torch.telemetry.report {out_root})")
        if recorder.tick_hooks:
            print(f"heartbeat hooks: {len(recorder.tick_hooks)} registered, "
                  f"{recorder.tick_hook_errors} failed")
    if alert_engine is not None:
        s = alert_engine.heartbeat_section()
        print(f"alerts: {s.get('firing', 0)} firing / "
              f"{s.get('pending', 0)} pending at exit — journal in "
              f"{out_root}/_alerts.jsonl, incident bundles in "
              f"{out_root}/_incidents/ (render with python -m "
              f"video_features_tpu_torch.telemetry.alerts {out_root})")
    if tracer is not None:
        print(f"trace: {tracer.trace_path} (render with python -m "
              f"video_features_tpu_torch.trace_report {out_root}, or open "
              "in https://ui.perfetto.dev)")
    if rf_observer is not None:
        print(f"roofline: {rf_observer.path} (render with python -m "
              f"video_features_tpu_torch.telemetry.roofline {out_root})")
    if parity_observer is not None:
        print(f"parity: per-seam numerics digests in {parity_observer.path} "
              f"(render with python -m video_features_tpu_torch parity "
              f"{out_root}; certify flips with python -m "
              "video_features_tpu_torch parity certify)")
    if capture.path is not None:
        print(f"profile trace: {capture.path} (torch.profiler; merge it "
              f"with the host trace by python -m "
              f"video_features_tpu_torch.trace_report {out_root} --merge "
              f"{capture.path}, or open in https://ui.perfetto.dev)")
    configs = per_family.values() if per_family is not None else [args]
    if any(a.get("health") for a in configs):
        print("health: per-(video, family) feature digests in "
              f"{{output_path}}/_health.jsonl under {out_root}")
    if args.get("profile"):
        print(profiler.summary(f"profile: {run_label} x {n_paths} videos"))


def _new_tally() -> dict:
    return {"done": 0, "skipped": 0, "error": 0, "quarantined": 0}


def _fleet_mode(args) -> str:
    return str(args.get("fleet", "static") or "static")


def recorder_host_id(args) -> str:
    """This process's ``p{rank}-{host}`` id (the JAX CLI's
    ``p{process_index}-{host}``); with ``fleet=queue`` qualified by the pid
    and a nonce, as in JAX, since queue workers may share one machine and
    each needs its own claims dir and heartbeat file."""
    host_id = f"p{_rank_and_world()[0]}-{socket.gethostname()}"
    if _fleet_mode(args) == "queue":
        host_id = f"{host_id}-{os.getpid()}-{uuid.uuid4().hex[:4]}"
    return host_id


def _new_recorder(args, per_family, out_root: str, run_label: str,
                  host_id: Optional[str] = None,
                  cc_baseline: Optional[dict] = None):
    """``telemetry=true``: a ``TelemetryRecorder`` over ``out_root``, not yet
    started (the caller attaches its hooks first), with ``host_id`` (else
    :func:`recorder_host_id`) and the kernel build's counts before the
    compile-cache attach (``cc_baseline``); else None."""
    if not args.get("telemetry"):
        return None
    from .telemetry.recorder import TelemetryRecorder
    run_config = (dict(args) if per_family is None else
                  {"feature_type": run_label,
                   "families": {f: dict(a) for f, a in per_family.items()}})
    return TelemetryRecorder(
        out_root, run_config=run_config, feature_type=run_label,
        interval_s=float(args.get("metrics_interval_s") or 30.0),
        host_id=host_id or recorder_host_id(args),
        compile_cache_baseline=cc_baseline)


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


def _drive(args, paths: List[str], run_one: Callable[[str], str],
           stop: threading.Event, work_queue=None,
           canary_extract: Optional[Callable] = None) -> None:
    """``run_one`` over ``paths``: in order, or on ``video_workers``
    threads (the host side of several videos feeding the mesh; each video
    keeps its own stream order and fault isolation); with ``work_queue``
    (``fleet=queue``) over the items this host claims from the shared queue
    instead (:func:`_drain_queue`). SIGTERM sets ``stop``: the videos in
    flight finish, the rest are dropped (atomic writes and the skip of
    finished outputs make a restarted run resume; a queue hands its
    claims back)."""
    workers = _video_workers(args.get("video_workers"))
    in_main = threading.current_thread() is threading.main_thread()
    prev_handler = None
    if in_main:
        def on_sigterm(signo, frame):
            print("SIGTERM: finishing in-flight video(s), dropping the rest")
            stop.set()
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        if work_queue is not None:
            _drain_queue(work_queue, args, run_one, stop, workers,
                         canary_extract)
        elif workers <= 1:
            for path in paths:
                if stop.is_set():
                    break
                run_one(path)
        else:
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


def _work_list(args) -> List[str]:
    """The shuffled video list; this host's static shard of it, or with
    ``fleet=queue`` all of it (every host seeds the full list)."""
    paths = video_list(args.get("video_paths"),
                       args.get("file_with_video_paths"), shuffle=True)
    return paths if _fleet_mode(args) == "queue" else \
        local_shard_of_list(paths)


def _open_queue(args, recorder, journal, paths: List[str]):
    """``fleet=queue``: this host's ``WorkQueue`` on the run's output root
    (``{out_root}/_queue/``), its ``fleet`` heartbeat section (which renews
    the leases on every tick) installed on ``recorder``, the canary's warm
    fast path taken from the attached compile-cache entry, and ``paths``
    seeded; else None."""
    if _fleet_mode(args) != "queue":
        return None
    if recorder is None:  # library callers can bypass sanity_check
        raise ValueError("fleet=queue needs telemetry=true: the heartbeat "
                         "thread renews the work-item leases")
    from .parallel.queue import WorkQueue
    work_queue = WorkQueue(
        recorder.output_path, host_id=recorder.host_id,
        run_id=recorder.run_id,
        lease_s=float(args.get("fleet_lease_s") or 60.0),
        max_reclaims=int(args.get("fleet_max_reclaims") or 3),
        journal=journal,
        staging_retention_s=(
            float(args["gc_staging_retention_s"])
            if args.get("gc_staging_retention_s") is not None else None))
    recorder.extra_sections["fleet"] = work_queue.heartbeat_section
    entry = compile_cache.active()
    work_queue.canary_warm = bool(entry is not None and entry.warm_at_attach)
    seeded = work_queue.seed(paths)
    print(f"fleet: queue mode — seeded {seeded} new item(s) into "
          f"{work_queue.root} as {work_queue.host_id}")
    return work_queue


def _drain_queue(work_queue, args, run_one: Callable[[str], str],
                 stop: threading.Event, workers: int,
                 canary_extract: Optional[Callable] = None) -> None:
    """Claim, extract, complete until the queue is drained fleet-wide, on
    ``workers`` threads; with ``fleet_canary=true`` the canary gate first
    (``canary_extract`` None: a multi-family run, which is not gated, as in
    JAX). Every claim still held at the end (an escaped exception,
    SIGTERM) goes back unbumped."""
    if args.get("fleet_canary"):
        if canary_extract is None:
            print("fleet canary: multi-family runs are not canary-gated "
                  "yet — claims open (per-family health gates still apply)")
        else:
            ok, lines = work_queue.canary_gate(canary_extract)
            print("\n".join(lines))
            if not ok:
                raise SystemExit(
                    "fleet canary: FAILED — this host is gated out of the "
                    "queue (digest or timing drift; verdict in "
                    f"{work_queue.root}/canary/)")
    try:
        work_queue.drain(run_one, workers=workers, stop=stop)
    finally:
        work_queue.release_all()


def _run(extractor, args, recorder=None, tally: Optional[dict] = None,
         failures: Optional[List[dict]] = None) -> int:
    """Every video of the work list under ``safe_extract``, each inside its
    telemetry span when ``recorder`` is set; fills ``tally`` and
    ``failures`` (the caller's, or its own) and returns the length of the
    work list."""
    tally = _new_tally() if tally is None else tally
    failures = [] if failures is None else failures
    policy = RetryPolicy.from_config(args)
    journal = (FailureJournal(args.output_path)
               if args.get("on_extraction", "print") != "print" else None)
    paths = _work_list(args)
    lock = threading.Lock()
    stop = threading.Event()

    def on_failure(record: dict) -> None:
        with lock:
            failures.append(record)

    def run_one(path: str) -> str:
        """One video; its status feeds the fleet queue's done marker
        ('dropped': preempted before it started, the claim is released)."""
        if stop.is_set():
            return "dropped"
        span_cm = (recorder.video_span(path) if recorder is not None
                   else NOOP_SPAN)
        with span_cm as span:
            status = safe_extract(extractor._extract, path, policy=policy,
                                  journal=journal,
                                  decode_mode=extractor.video_decode,
                                  on_terminal_failure=on_failure)
            span.annotate(status=status)
        with lock:
            tally[status] += 1
        return status

    def canary_extract(video_path: str, canary_dir: str):
        """The fleet canary's re-extraction of one completed video into a
        throwaway dir with a fresh extractor: cache off (the gate must
        recompute, not re-serve), health on (the digest bands need
        digests)."""
        from .cache import _plain
        c_args = Config(_plain(args))
        c_args.output_path = canary_dir
        c_args.cache = False
        c_args.health = True
        c_ext = get_extractor_cls(args.feature_type)(c_args)
        t_c = time.perf_counter()
        status = safe_extract(c_ext._extract, video_path, policy=policy,
                              journal=None, decode_mode=c_ext.video_decode)
        return status, time.perf_counter() - t_c

    work_queue = _open_queue(args, recorder, journal, paths)
    t0 = time.perf_counter()
    _drive(args, paths, run_one, stop, work_queue, canary_extract)
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
    return len(paths)


def _run_multi(multi, args, recorder=None, tally: Optional[dict] = None,
               failures: Optional[List[dict]] = None) -> int:
    """Every family on each video over one decode: the tally counts
    (video, family) units, with one summary line per family and one
    journal line per family that failed; ``recorder`` gets a span per
    (video, family). ``video_workers`` counts videos; each video's
    families run on their own threads inside it. Returns the length of the
    work list."""
    tally = _new_tally() if tally is None else tally
    failures = [] if failures is None else failures
    paths = _work_list(args)
    fam_tally = {f: _new_tally() for f in multi.families}
    videos_run = [0]
    lock = threading.Lock()
    stop = threading.Event()

    def run_one(path: str) -> str:
        if stop.is_set():
            return "dropped"
        with lock:
            videos_run[0] += 1
        statuses = multi.run_video(path, recorder=recorder,
                                   failures=failures)
        with lock:
            for fam, status in statuses.items():
                tally[status] += 1
                fam_tally[fam][status] += 1
        # one done marker per video: the worst per-family verdict
        for agg in ("error", "quarantined", "done"):
            if agg in statuses.values():
                return agg
        return "skipped"

    work_queue = _open_queue(args, recorder, None, paths)
    t0 = time.perf_counter()
    _drive(args, paths, run_one, stop, work_queue)
    elapsed = time.perf_counter() - t0
    summary = (f"{videos_run[0]}/{len(paths)} videos x "
               f"{len(multi.families)} families in {elapsed:.1f}s: "
               f"{tally['done']} extracted, {tally['skipped']} already "
               f"done, {tally['error']} failed")
    if tally["quarantined"]:
        summary += f", {tally['quarantined']} quarantined"
    if tally["done"]:
        summary += f" ({tally['done'] / elapsed:.2f} extractions/s)"
    print(summary)
    for fam in multi.families:
        ft = fam_tally[fam]
        line = (f"  {fam}: {ft['done']} extracted, {ft['skipped']} "
                f"already done, {ft['error']} failed")
        if ft["quarantined"]:
            line += f", {ft['quarantined']} quarantined"
        print(line)
    for fam in sorted({rec.get("family") for rec in failures
                       if rec.get("family")}):
        journal = multi.journals.get(fam)
        if journal is not None:
            print(f"failure journal ({fam}): {journal.path} "
                  "(retry_failed=true re-runs quarantined videos)")
    if stop.is_set():
        raise SystemExit(143)  # the conventional SIGTERM status
    return len(paths)
