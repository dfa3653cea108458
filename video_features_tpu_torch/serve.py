"""Warm serving over a file spool (port of ``video_features_tpu/serve.py``).

The batch CLI is a cold job: import torch, build the kernels, put the
weights on the card, drain a list, exit. At serving scale that cold tax
dominates small requests. ``python -m video_features_tpu_torch serve ...``
keeps one process alive with:

  - the **compile cache** attached once (``compile_cache.py``): the kernel
    library is loaded at the first request and never rebuilt; a restarted
    server re-attaches a warm entry and runs no ``nvcc``;
  - **weights resident**: each family's extractor is built once and its
    weights stay on the card for the process lifetime;
  - **cross-request packing**: with ``cross_video_batching=true`` the
    extractor's one packer (``parallel/packer.py``) outlives requests, so
    clips of concurrent requests fill the same fixed-shape groups, with the
    packer's failure containment (a failed group fails exactly its member
    videos, each reported in its own request's response);
  - the **feature cache** (``cache.py``): with ``cache=true`` repeat
    content is served before any decoder is built.

**Spool protocol** (the JAX package's layout and schemas, so either
package's clients and servers share one spool):

  ======================================  ==================================
  ``{spool}/requests/``                   clients atomically rename request
                                          JSON in
  ``{spool}/claimed/{host_id}/``          a server claims by ``os.rename``
                                          into its own subdir, which ties
                                          each claim to its owner's
                                          heartbeat
  ``{spool}/done/``                       one response JSON per request
  ``{spool}/expired/``                    ``deadline_exceeded`` records
  ``{spool}/_heartbeat_{host_id}.json``   liveness and readiness: the
                                          telemetry heartbeat plus a
                                          ``serve`` section
  ======================================  ==================================

**Claim reclamation**: every live server sweeps the other claim dirs; when
an owner's heartbeat is missing, final, or silent past the stall window, its
claims go back to ``requests/`` (first sweeper wins the rename), unless the
response already landed.

A request is ``{"id": ..., "video_paths": [...]}``; the response carries
per-video statuses, the output root, wait and latency seconds, and the
request's compile-cache delta. **Admission**: a backlog past
``serve_max_pending`` rejects new requests at once (a ``rejected``
response), and claiming waits while the fan-out gauges report backpressure.

**Correlation** (``telemetry/context.py``): a request's videos run under
``use_request(id)``, so every span, health digest, journal record and trace
span they produce carries the request id.

**SLOs**: queue wait (submit to claim) and service (claim to response) land
in the ``vft_serve_queue_wait_seconds`` / ``vft_serve_service_seconds``
histograms; with ``serve_slo_s`` a request whose wait + service exceeds it
bumps ``vft_serve_slo_violations_total``. The heartbeat's ``serve`` section
publishes p50/p95/p99 of both and the attainment. ``trace=true`` runs the
trace recorder homed on the spool.

**Deadlines and tenants** (``gateway.py``): a request may carry an absolute
``deadline``; the server does not start it past the deadline, stops between
videos when it passes, and writes ``expired/{id}.json`` (status
``deadline_exceeded``), never a ``done/`` response. Gateway-minted ids
(``{tenant}-{rid}``) land in per-tenant tallies (``serve.tenants``,
``vft_tenant_*_total``).

The serve keys: ``spool_dir`` (required), ``serve_workers``,
``serve_max_pending``, ``serve_poll_interval_s``, ``serve_slo_s``,
``serve_idle_exit_s`` and ``serve_max_requests`` (the last two bound a
session: tests and smoke runs). SIGTERM finishes the requests in flight,
writes a final heartbeat and exits 143.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

REQUESTS_DIR = "requests"
CLAIMED_DIR = "claimed"
DONE_DIR = "done"
#: terminal ``deadline_exceeded`` records live HERE, never in ``done/``:
#: a request that expired has no response — it has an expiry record, and
#: the audit (the JAX package's audit.py) holds the two directories
#: mutually exclusive per request id
EXPIRED_DIR = "expired"

#: request/response schema identifiers
REQUEST_SCHEMA = "vft.serve_request/1"
RESPONSE_SCHEMA = "vft.serve_response/1"


def tenant_of_request_id(request_id: Optional[str]) -> Optional[str]:
    """``{tenant}-{rid}`` gateway-minted ids -> tenant; plain spool ids
    -> None (delegates to telemetry/context.py, the single parser)."""
    from .telemetry.context import tenant_of
    return tenant_of(request_id)


# -- client side -------------------------------------------------------------

def spool_paths(spool_dir: str) -> Dict[str, str]:
    root = str(spool_dir)
    return {name: os.path.join(root, name)
            for name in (REQUESTS_DIR, CLAIMED_DIR, DONE_DIR, EXPIRED_DIR)}


def ensure_spool(spool_dir: str) -> None:
    for p in spool_paths(spool_dir).values():
        os.makedirs(p, exist_ok=True)


def submit_request(spool_dir: str, video_paths: List[str],
                   request_id: Optional[str] = None,
                   deadline: Optional[float] = None) -> str:
    """Drop one request into the spool (atomic: temp + rename INTO
    ``requests/``, so the server can never claim a half-written file);
    returns the request id.

    ``deadline`` is an absolute unix time past which the request is
    worthless to its caller: the server refuses to START it past the
    deadline (claim-time check), stops BETWEEN videos when it passes
    mid-request, and writes a terminal ``expired/`` record either way —
    the end-to-end deadline contract the gateway stamps from the
    client's ``timeout_s`` (gateway.py)."""
    ensure_spool(spool_dir)
    rid = request_id or uuid.uuid4().hex[:12]
    req = {"schema": REQUEST_SCHEMA, "id": rid,
           "video_paths": [str(v) for v in video_paths],
           "time": round(time.time(), 3)}
    if deadline is not None:
        req["deadline"] = round(float(deadline), 3)
    final = os.path.join(spool_dir, REQUESTS_DIR, f"{rid}.json")
    tmp = os.path.join(spool_dir, f".{rid}.json.tmp")
    try:
        # vft-lint: disable=VFT004 — this IS the temp+fsync+os.replace discipline, open-coded because the tmp name doubles as the spool claim-protocol dotfile
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(req, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        # unlink-on-failure, the sink discipline (utils/sinks.py): a raise
        # between the temp write and the rename (ENOSPC at fsync, a dying
        # client) must not litter the spool with .tmp files forever —
        # the audit's no-tmp-litter invariant covers spools too
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return rid


def read_response(spool_dir: str, request_id: str) -> Optional[dict]:
    path = os.path.join(spool_dir, DONE_DIR, f"{request_id}.json")
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_terminal(spool_dir: str, request_id: str) -> Optional[dict]:
    """The request's terminal record, whichever directory holds it: the
    ``done/`` response, or the ``expired/`` deadline record (status
    ``deadline_exceeded``). None while the request is still open."""
    resp = read_response(spool_dir, request_id)
    if resp is not None:
        return resp
    path = os.path.join(spool_dir, EXPIRED_DIR, f"{request_id}.json")
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def wait_response(spool_dir: str, request_id: str,
                  timeout_s: float = 300.0,
                  poll_s: float = 0.1) -> dict:
    """Block until the terminal record for ``request_id`` lands (or
    raise TimeoutError) — a ``done/`` response, or the ``expired/``
    deadline record for a request whose deadline passed. Polling a
    local/shared filesystem is the protocol — clients need nothing but
    the spool mount."""
    deadline = time.monotonic() + float(timeout_s)
    while True:
        resp = read_terminal(spool_dir, request_id)
        if resp is not None:
            return resp
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no response for request {request_id} within {timeout_s}s")
        time.sleep(poll_s)


def server_state(spool_dir: str) -> Dict[str, Any]:
    """Client-side readiness probe: the freshest matching heartbeat's
    ``serve`` section (+ liveness verdict), or ``{"state": "absent"}``.
    Readiness == a fresh heartbeat whose serve state is ``ready``."""
    import glob
    from .telemetry.heartbeat import HEARTBEAT_GLOB, STALL_INTERVALS
    best: Optional[dict] = None
    for p in glob.glob(os.path.join(spool_dir, HEARTBEAT_GLOB)):
        try:
            with open(p, encoding="utf-8") as f:
                hb = json.load(f)
        except (OSError, ValueError):
            continue
        if "serve" not in hb:
            # the gateway heartbeats on the same spool (gateway.py) but
            # carries no serve section — readiness is about SERVERS, so
            # its liveness must never masquerade as a backend verdict
            continue
        if best is None or float(hb.get("time", 0)) > \
                float(best.get("time", 0)):
            best = hb
    if best is None:
        return {"state": "absent"}
    age = max(0.0, time.time() - float(best.get("time", 0)))
    interval = float(best.get("interval_s", 30.0)) or 30.0
    serve = dict(best.get("serve") or {})
    if best.get("final"):
        serve["state"] = "exited"
    elif age > STALL_INTERVALS * interval:
        serve["state"] = "stalled"
    serve.setdefault("state", "unknown")
    serve["heartbeat_age_s"] = round(age, 3)
    serve["run_id"] = best.get("run_id")
    return serve


# -- server side -------------------------------------------------------------

class ServeLoop:
    """The warm server: construct once, :meth:`run` until bounded out or
    signalled. Separated from :func:`main` so tests/benches can drive it
    in-process (a thread) with injected bounds."""

    def __init__(self, args, per_family=None,
                 out_root: Optional[str] = None) -> None:
        self.args = args
        self.per_family = per_family  # multi-family: {family: Config}
        self.spool_dir = str(args.spool_dir)
        self.paths = spool_paths(self.spool_dir)
        ensure_spool(self.spool_dir)
        self.poll_s = float(args.get("serve_poll_interval_s") or 0.25)
        self.max_pending = int(args.get("serve_max_pending") or 64)
        self.idle_exit_s = args.get("serve_idle_exit_s")
        self.max_requests = args.get("serve_max_requests")
        workers = args.get("serve_workers") or args.get("video_workers") or 1
        if workers == "auto":
            workers = max(1, min(8, (os.cpu_count() or 1) // 2))
        self.workers = max(1, int(workers))
        self._stop = threading.Event()
        self._state = "warming"
        self._state_lock = threading.Lock()
        self._tallies = {"done": 0, "partial": 0, "failed": 0,
                         "rejected": 0, "deadline_exceeded": 0}
        # per-tenant request/violation/reject tallies (gateway-minted
        # ids carry a tenant prefix, telemetry/context.py tenant_of):
        # published in the heartbeat serve section and rolled fleet-wide
        # by the fleet report's --prom as vft_tenant_*_total{tenant}
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._inflight = 0
        self._inflight_rids: set = set()
        # SLO accounting: the latency *distributions* live in the
        # recorder registry's fixed-bucket histograms (bounded by
        # construction); this deque only keeps a small recent window for
        # the heartbeat's last/mean lines. The unbounded per-request
        # list this replaces grew for the life of the server.
        import collections
        self._recent = collections.deque(maxlen=32)
        slo = args.get("serve_slo_s")
        self.slo_s = float(slo) if slo is not None else None
        self._answered = 0
        self._slo_violations = 0

        # fleet-shared compile cache (compile_cache.py): attached before
        # the warm construction below, so the kernel library comes from
        # the entry (or is built into it) and a restarted server's first
        # request runs no nvcc; sealed when run() exits
        from . import compile_cache
        cc_baseline = compile_cache.snapshot()
        self.compile_cache_entry = (
            compile_cache.attach_for_multi_args(per_family)
            if per_family is not None
            else compile_cache.attach_for_args(args.feature_type, args))

        # -- warm construction: params resident for the process lifetime --
        if per_family is not None:
            from .extractors.multi import MultiExtractor
            self.multi = MultiExtractor(per_family)
            self.extractor = None
        else:
            from .registry import get_extractor_cls
            from .utils.faults import FailureJournal, RetryPolicy
            self.multi = None
            self.extractor = get_extractor_cls(args.feature_type)(args)
            self.policy = RetryPolicy.from_config(args)
            self.journal = (FailureJournal(args.output_path)
                            if args.get("on_extraction") != "print"
                            else None)
        self.out_root = str(out_root if out_root is not None
                            else args.output_path)

        # the telemetry recorder is not optional in serve mode: its
        # heartbeat in the spool is the liveness and readiness protocol
        # (clients read it with server_state); one recorder, homed on the
        # spool, is the single source of truth
        import socket
        from .cache import _plain
        from .parallel.mesh import _rank_and_world
        from .telemetry.recorder import TelemetryRecorder
        host_id = f"p{_rank_and_world()[0]}-{socket.gethostname()}"
        # pid-qualify: servers sharing one machine (and one spool) need
        # distinct claim dirs + heartbeat files, and the claim-dir name
        # must map 1:1 onto a heartbeat so sweepers can judge the owner
        host_id = f"{host_id}-{os.getpid()}"
        from .parallel.queue import _safe
        self.claim_dirname = _safe(host_id)
        self.claim_dir = os.path.join(self.paths[CLAIMED_DIR],
                                      self.claim_dirname)
        os.makedirs(self.claim_dir, exist_ok=True)
        self._last_reclaim_sweep = 0.0
        families = (list(per_family) if per_family is not None
                    else [args.feature_type])
        self.families = families
        run_config = (_plain(args) if per_family is None else
                      {"feature_type": ",".join(families),
                       "families": {f: _plain(a)
                                    for f, a in per_family.items()}})
        self.recorder = TelemetryRecorder(
            self.spool_dir, run_config=run_config,
            feature_type=",".join(families),
            interval_s=float(args.get("metrics_interval_s") or 5.0),
            host_id=host_id, compile_cache_baseline=cc_baseline)
        self.recorder.extra_sections["serve"] = self._serve_section

        # retained history + alerting, homed on the spool like the
        # heartbeat (telemetry/history.py, telemetry/alerts.py): the SLO
        # burn-rate rule diffs this server's own retained
        # requests/violations counters on every tick, so a burn pages
        # without any external watcher. Registered before run() calls
        # recorder.start() — the t=0 heartbeat seeds the windows.
        self.alert_engine = None
        if bool(args.get("history", False)) or bool(args.get("alerts",
                                                             False)):
            from .telemetry.history import HistoryWriter
            HistoryWriter(self.spool_dir, host_id).attach(self.recorder)
        if bool(args.get("alerts", False)):
            from .telemetry.alerts import AlertEngine
            self.alert_engine = AlertEngine(
                self.spool_dir,
                run_id=self.recorder.run_id).attach(self.recorder)

        # pipeline tracing (trace=true): the Chrome-trace recorder homed
        # on the SPOOL dir like the heartbeat, so `serve.request` /
        # `video_attempt` windows (each stamped with its request id) land
        # on the timeline the fleet report's --stitch merges. Same
        # lifecycle as the batch CLI's: armed here, drained at exit.
        self.tracer = None
        if bool(args.get("trace", False)):
            from .telemetry.trace import TraceRecorder
            # per-host filename: sibling servers share one spool, and
            # each must leave its own stitchable timeline behind
            self.tracer = TraceRecorder(self.spool_dir,
                                        host_id=host_id).start()

    # -- heartbeat serve section ------------------------------------------
    def _serve_section(self) -> dict:
        from .telemetry.metrics import LATENCY_BUCKETS, histogram_quantiles
        with self._state_lock:
            lat = list(self._recent)
            answered = self._answered
            violations = self._slo_violations
            section = {
                "state": self._state,
                "pending": self._pending_count(),
                "inflight": self._inflight,
                "active_requests": sorted(self._inflight_rids),
                "workers": self.workers,
                "max_pending": self.max_pending,
                "requests": dict(self._tallies),
            }
            if self._tenants:
                section["tenants"] = {t: dict(v) for t, v
                                      in sorted(self._tenants.items())}
        if lat:
            section["last_latency_s"] = round(lat[-1], 3)
            section["mean_latency_s"] = round(sum(lat) / len(lat), 3)
        # SLO block: percentiles straight off the registry histograms —
        # a pure function of bounded state, so a scraper (or the fleet
        # report)
        # reads p50/p95/p99 + attainment from the heartbeat file alone
        reg = self.recorder.registry
        section["slo"] = {
            "slo_s": self.slo_s,
            "requests": answered,
            "violations": violations,
            "attainment_pct": (round(100.0 * (answered - violations)
                                     / answered, 2) if answered else None),
            "queue_wait": histogram_quantiles(reg.histogram(
                "vft_serve_queue_wait_seconds",
                buckets=LATENCY_BUCKETS).snapshot()),
            "service": histogram_quantiles(reg.histogram(
                "vft_serve_service_seconds",
                buckets=LATENCY_BUCKETS).snapshot()),
        }
        return section

    def _tenant_bump(self, tenant: Optional[str], key: str) -> None:
        """One per-tenant tally + its labelled registry counter; a
        no-op for untenanted (spool-direct) request ids."""
        if not tenant:
            return
        with self._state_lock:
            t = self._tenants.setdefault(
                tenant, {"requests": 0, "violations": 0, "rejects": 0})
            t[key] += 1
        name = {"requests": "vft_tenant_requests_total",
                "violations": "vft_tenant_slo_violations_total",
                "rejects": "vft_tenant_rejects_total"}[key]
        self.recorder.registry.counter(name, tenant=tenant).inc()

    def _account_request(self, wait_s: float, service_s: float,
                         tenant: Optional[str] = None) -> bool:
        """Fold one answered request into the SLO state: both splits into
        their histograms, the recent window, and — when ``serve_slo_s``
        is set — the violation counter when wait+service exceeds it.
        Gateway-minted ids additionally land in the per-tenant tallies.
        Returns True when this request violated the SLO."""
        from .telemetry.metrics import LATENCY_BUCKETS
        reg = self.recorder.registry
        reg.histogram("vft_serve_queue_wait_seconds",
                      buckets=LATENCY_BUCKETS).observe(wait_s)
        reg.histogram("vft_serve_service_seconds",
                      buckets=LATENCY_BUCKETS).observe(service_s)
        violated = (self.slo_s is not None
                    and wait_s + service_s > self.slo_s)
        with self._state_lock:
            self._recent.append(service_s)
            self._answered += 1
            if violated:
                self._slo_violations += 1
        if violated:
            reg.counter("vft_serve_slo_violations_total").inc()
        self._tenant_bump(tenant, "requests")
        if violated:
            self._tenant_bump(tenant, "violations")
        return violated

    def _pending_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.paths[REQUESTS_DIR])
                       if n.endswith(".json"))
        except OSError:
            return 0

    def _set_state(self, state: str) -> None:
        with self._state_lock:
            self._state = state
        # readiness must be visible promptly, not at the next interval
        try:
            self.recorder.write_heartbeat()
        except Exception:
            pass

    # -- request processing ------------------------------------------------
    def _respond(self, rid: str, payload: dict) -> bool:
        """Write the ``done/`` response atomically; returns False when
        the write was LOST (the injected ``spool.respond`` drop — a
        crashed NFS write, a dying server). Callers must treat False as
        \"the requester will never hear us\": requeue the claim so a
        later pass (or sibling) answers, instead of silently swallowing
        the request."""
        from .telemetry import jsonl
        from .utils import inject
        fault = inject.fire("spool.respond", request=rid)
        if fault is not None and fault.kind == "drop":
            return False
        payload = {"schema": RESPONSE_SCHEMA, "id": rid,
                   "time": round(time.time(), 3), **payload}
        jsonl.write_json_atomic(
            os.path.join(self.paths[DONE_DIR], f"{rid}.json"), payload)
        return True

    def _expire(self, rid: str, req: dict, claimed_path: str,
                statuses: Dict[str, Dict[str, str]], where: str) -> None:
        """Terminal ``deadline_exceeded``: write the ``expired/`` record
        (NEVER a ``done/`` response — the audit holds the two mutually
        exclusive), count it, and release the claim. ``statuses`` holds
        whatever videos finished before the deadline passed
        (``where="claim"`` means none — the wasted-work guard fired
        before any decode/device time burned)."""
        from .telemetry import jsonl
        tenant = tenant_of_request_id(rid)
        rec = {"schema": RESPONSE_SCHEMA, "id": rid,
               "status": "deadline_exceeded",
               "time": round(time.time(), 3),
               "deadline": req.get("deadline"),
               "expired_at": where,
               "videos": statuses,
               "processed": len(statuses)}
        if tenant:
            rec["tenant"] = tenant
        jsonl.write_json_atomic(
            os.path.join(self.paths[EXPIRED_DIR], f"{rid}.json"), rec)
        from . import telemetry
        telemetry.inc("vft_serve_deadline_exceeded_total")
        with self._state_lock:
            self._tallies["deadline_exceeded"] += 1
            # an expired request IS an answered-and-violated request for
            # attainment purposes: without these, deadline-heavy load makes
            # attainment_pct overstate health (the fleet-wide block would
            # only ever see the requests that finished in time)
            self._answered += 1
            self._slo_violations += 1
        self.recorder.registry.counter(
            "vft_serve_slo_violations_total").inc()
        self._tenant_bump(tenant, "requests")
        self._tenant_bump(tenant, "violations")
        try:
            os.unlink(claimed_path)
        except OSError:
            pass
        print(f"serve: request {rid} deadline exceeded at {where} "
              f"({len(statuses)} video(s) finished before expiry)",
              file=sys.stderr)

    def _run_one_video(self, video_path: str) -> Dict[str, str]:
        """One video through the warm extractor(s); returns
        {family: status} with safe_extract's vocabulary."""
        from .utils.sinks import safe_extract
        if self.multi is not None:
            return self.multi.run_video(video_path, recorder=self.recorder)
        with self.recorder.video_span(video_path) as span:
            status = safe_extract(self.extractor._extract, video_path,
                                  policy=self.policy, journal=self.journal,
                                  decode_mode=self.extractor.video_decode)
            span.annotate(status=status)
        return {self.args.feature_type: status}

    def _process(self, claimed_path: str) -> None:
        from .telemetry import trace
        rid = os.path.basename(claimed_path)[:-len(".json")]
        t0 = time.perf_counter()
        from . import compile_cache
        cc_before = compile_cache.snapshot()
        try:
            with open(claimed_path, encoding="utf-8") as f:
                req = json.load(f)
            videos = [str(v) for v in req.get("video_paths") or []]
        except (OSError, ValueError) as e:
            self._respond(rid, {"status": "failed",
                                "error": f"unreadable request: {e}"})
            with self._state_lock:
                self._tallies["failed"] += 1
            os.unlink(claimed_path)
            return
        wait_s = max(0.0, time.time() - float(req.get("time") or time.time()))
        deadline = req.get("deadline")
        deadline = float(deadline) if deadline is not None else None
        if deadline is not None and time.time() >= deadline:
            # wasted-work guard: the request expired while QUEUED — the
            # caller stopped waiting, so cancel at claim time, before any
            # decode/device second burns (the audit pins zero spans for
            # claim-expired requests)
            self._expire(rid, req, claimed_path, {}, "claim")
            return
        statuses: Dict[str, Dict[str, str]] = {}
        expired = False
        from .telemetry.context import use_request
        with self._state_lock:
            self._inflight_rids.add(rid)
        try:
            # request-scoped correlation: every span/health/journal/trace
            # record the videos below produce carries this request's id
            # (telemetry/context.py) — thread-local, so concurrent
            # requests on sibling workers never cross-stamp
            with use_request(rid), \
                    trace.span("serve.request", id=rid, videos=len(videos)):
                # videos of ONE request run on this request's worker
                # thread sequentially; concurrency comes from multiple
                # claimed requests in flight, which is exactly what packs
                # their clips into shared device groups
                # (parallel/packer.py)
                for v in videos:
                    # deadline re-check BETWEEN videos: expiry mid-request
                    # stops before the next decode, keeping whatever
                    # partial results already landed
                    if deadline is not None and time.time() >= deadline:
                        expired = True
                        break
                    if self._stop.is_set():
                        statuses[v] = {f: "dropped" for f in self.families}
                        continue
                    try:
                        statuses[v] = self._run_one_video(v)
                    except Exception as e:  # safe_extract contains
                        # per-video failures; this guards the serve loop
                        statuses[v] = {f: "error" for f in self.families}
                        print(f"serve: request {rid} video {v} escaped: "
                              f"{type(e).__name__}: {e}", file=sys.stderr)
        finally:
            with self._state_lock:
                self._inflight_rids.discard(rid)
        # the deadline also gates the RESPONSE: a request that finished
        # its last video past the deadline still expires — the caller is
        # gone, and done/ vs expired/ stay mutually exclusive
        if deadline is not None and time.time() >= deadline:
            expired = True
        if expired:
            self._expire(rid, req, claimed_path, statuses,
                         "mid_request" if statuses else "claim")
            return
        flat = [s for per in statuses.values() for s in per.values()]
        ok = all(s in ("done", "skipped") for s in flat) and flat
        latency = time.perf_counter() - t0
        payload = {
            "status": "done" if ok else "partial",
            "videos": statuses,
            "output_path": self.out_root,
            "wait_s": round(wait_s, 3),
            "latency_s": round(latency, 3),
            # the kernel build's hits and misses during this request: 0
            # and 0 after the first (the library stays loaded)
            "compile_cache": compile_cache.summary(cc_before),
        }
        if self.slo_s is not None:
            payload["slo_violated"] = bool(wait_s + latency > self.slo_s)
        if not self._respond(rid, payload):
            # the response write was LOST (injected spool.respond drop /
            # a dying store): requeue the claim so a later pass answers —
            # idempotent re-serving is cheap (sink skip-if-exists + the
            # content-addressed cache), and accounting happens only on
            # the pass whose response actually lands
            try:
                os.rename(claimed_path, os.path.join(
                    self.paths[REQUESTS_DIR], f"{rid}.json"))
            except OSError:
                pass
            print(f"serve: response write for {rid} lost — requeued",
                  file=sys.stderr)
            return
        self._account_request(wait_s, latency,
                              tenant=tenant_of_request_id(rid))
        with self._state_lock:
            self._tallies["done" if ok else "partial"] += 1
        try:
            os.unlink(claimed_path)
        except OSError:
            pass

    def _claim_next(self) -> Optional[str]:
        """Claim the oldest pending request by atomic rename; None when
        the spool is empty (or every candidate was raced away)."""
        req_dir = self.paths[REQUESTS_DIR]
        try:
            names = [n for n in os.listdir(req_dir) if n.endswith(".json")]
        except OSError:
            return None
        from .utils import inject
        for name in sorted(
                names,
                key=lambda n: self._mtime(os.path.join(req_dir, n))):
            src = os.path.join(req_dir, name)
            dst = os.path.join(self.claim_dir, name)
            try:
                # chaos hook (utils/inject.py `spool.claim`): a failed
                # claim rename looks exactly like a lost race — the
                # request stays spooled for the next pass/server
                inject.fire("spool.claim", request=name[:-len(".json")])
                os.rename(src, dst)
                return dst
            except OSError:
                continue  # another server (or a withdrawal) won the race
        return None

    def _reclaim_orphans(self) -> int:
        """Release a dead server's spool claims (the fleet queue's
        lease-expiry discipline): claims whose owner's heartbeat is
        missing, final, or stale go back to ``requests/``; claims whose
        response already landed are dropped. Returns requeued count."""
        from .telemetry.heartbeat import STALL_INTERVALS, heartbeat_filename
        root = self.paths[CLAIMED_DIR]
        try:
            entries = os.listdir(root)
        except OSError:
            return 0
        requeued = 0
        now = time.time()
        for entry in entries:
            p = os.path.join(root, entry)
            if entry.endswith(".json") and os.path.isfile(p):
                # flat claim: a pre-reclamation server crashed holding it;
                # no owner dir means no heartbeat to wait out
                requeued += self._release_claim(p)
                continue
            if entry == self.claim_dirname or not os.path.isdir(p):
                continue
            hb = None
            try:
                with open(os.path.join(self.spool_dir,
                                       heartbeat_filename(entry)),
                          encoding="utf-8") as f:
                    hb = json.load(f)
            except (OSError, ValueError):
                pass
            if hb is not None and not hb.get("final"):
                interval = float(hb.get("interval_s", 30.0) or 30.0)
                if now - float(hb.get("time", 0)) <= \
                        STALL_INTERVALS * interval:
                    continue  # owner is alive; its claims are its own
            try:
                names = [n for n in os.listdir(p) if n.endswith(".json")]
            except OSError:
                continue
            for name in names:
                requeued += self._release_claim(os.path.join(p, name))
        return requeued

    def _release_claim(self, path: str) -> int:
        """Move one orphaned claim back to ``requests/`` (atomic rename;
        a racing sweeper loses with ENOENT) — or drop it when its
        response already exists (the owner died between respond and
        cleanup; re-serving would only repeat finished work)."""
        from . import telemetry
        name = os.path.basename(path)
        rid = name[:-len(".json")]
        if os.path.exists(os.path.join(self.paths[DONE_DIR], name)):
            try:
                os.unlink(path)
            except OSError:
                pass
            return 0
        try:
            os.rename(path, os.path.join(self.paths[REQUESTS_DIR], name))
        except OSError:
            return 0  # a racing sweeper (or the resurrected owner) won
        telemetry.inc("vft_serve_reclaimed_total")
        print(f"serve: reclaimed orphaned claim {rid} from a dead "
              "server", file=sys.stderr)
        return 1

    @staticmethod
    def _mtime(path: str) -> float:
        try:
            return os.path.getmtime(path)
        except OSError:
            return float("inf")

    def _reject_overflow(self) -> None:
        """Admission control: beyond ``serve_max_pending`` queued
        requests, refuse NEWEST arrivals immediately — a bounded queue
        with a fast no is kinder to callers (they can retry elsewhere)
        than an unbounded one that times them all out."""
        req_dir = self.paths[REQUESTS_DIR]
        try:
            names = sorted(
                (n for n in os.listdir(req_dir) if n.endswith(".json")),
                key=lambda n: self._mtime(os.path.join(req_dir, n)))
        except OSError:
            return
        for name in names[self.max_pending:][::-1]:
            src = os.path.join(req_dir, name)
            dst = os.path.join(self.claim_dir, name)
            try:
                os.rename(src, dst)
            except OSError:
                continue
            rid = name[:-len(".json")]
            if not self._respond(rid, {
                    "status": "rejected",
                    "error": f"server backlog over serve_max_pending="
                             f"{self.max_pending}; retry later"}):
                # lost rejection write: put the request back — a silent
                # drop would strand the caller with no terminal record
                try:
                    os.rename(dst, src)
                except OSError:
                    pass
                continue
            with self._state_lock:
                self._tallies["rejected"] += 1
            self._tenant_bump(tenant_of_request_id(rid), "rejects")
            try:
                os.unlink(dst)
            except OSError:
                pass

    def _backpressured(self) -> bool:
        """Defer claiming while the pipeline's own gauges say the decode
        fan-out is saturated (``vft_fanout_queue_depth``): admitting
        more work would only grow in-process queues, not throughput."""
        snap = self.recorder.fanout_snapshot()
        depths = snap.get("queue_depth") or {}
        if not depths:
            return False
        depth_cap = float(getattr(self, "_fanout_depth_cap", 0) or 0)
        if depth_cap <= 0:
            from .parallel import fanout
            first = (next(iter(self.per_family.values()))
                     if self.per_family else self.args)
            self._fanout_depth_cap = depth_cap = float(
                first.get("fanout_depth") or fanout.DEFAULT_DEPTH)
        return max(depths.values()) >= depth_cap

    # -- main loop ---------------------------------------------------------
    def run(self) -> int:
        self.recorder.start()
        self._set_state("ready")
        print(f"serve: ready — spool={self.spool_dir} "
              f"families={','.join(self.families)} workers={self.workers} "
              f"(heartbeat {self.recorder.heartbeat_path})")
        from concurrent.futures import ThreadPoolExecutor
        served = 0
        idle_since = time.monotonic()
        futures = set()
        try:
            with ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="vft-serve") as pool:
                while not self._stop.is_set():
                    futures = {f for f in futures if not f.done()}
                    with self._state_lock:
                        self._inflight = len(futures)
                    # lease-expiry sweep on the heartbeat cadence: a dead
                    # sibling's stall window is measured in its own
                    # interval_s, so sweeping faster buys nothing
                    if time.monotonic() - self._last_reclaim_sweep >= \
                            min(self.recorder.interval_s, 5.0):
                        self._last_reclaim_sweep = time.monotonic()
                        self._reclaim_orphans()
                    self._reject_overflow()
                    claimed = None
                    if len(futures) < self.workers \
                            and not self._backpressured():
                        claimed = self._claim_next()
                    if claimed is not None:
                        served += 1
                        idle_since = time.monotonic()
                        futures.add(pool.submit(self._process, claimed))
                        if self.max_requests is not None \
                                and served >= int(self.max_requests):
                            break
                        continue  # drain the spool before sleeping
                    if not futures:
                        if self.idle_exit_s is not None and \
                                time.monotonic() - idle_since \
                                >= float(self.idle_exit_s):
                            print("serve: idle past "
                                  f"serve_idle_exit_s={self.idle_exit_s} — "
                                  "exiting")
                            break
                    self._stop.wait(self.poll_s)
                # bounded exit or stop: wait for in-flight requests (their
                # responses must land; atomic sinks make partial work safe)
                self._set_state("draining")
                for f in list(futures):
                    f.result()
        finally:
            with self._state_lock:
                self._inflight = 0
                self._state = "exited"
            self.recorder.close(tally=None, wall_s=None)
            if self.tracer is not None:
                # atomic temp+rename at close — an aborted server still
                # leaves a complete, stitchable trace behind
                self.tracer.close()
            # seal the compile-cache entry: the restarted server (or any
            # fleet sibling with the same fingerprint) attaches warm
            from . import compile_cache
            compile_cache.seal_active()
        return 143 if self._stop.is_set() else 0

    def stop(self) -> None:
        self._stop.set()


SERVE_USAGE = ("Usage: python -m video_features_tpu_torch serve "
               "feature_type=<family>[,...] spool_dir=<dir> [key=value ...]")


def serve_main(argv: Optional[List[str]] = None) -> None:
    """Entry point: ``python -m video_features_tpu_torch serve key=value
    ...``."""
    from .config import (load_config, load_multi_config, parse_dotlist,
                         sanity_check, sanity_check_multi)
    from .registry import parse_feature_types
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] in (["-h"], ["--help"]):
        print(SERVE_USAGE)
        return
    cli_args = parse_dotlist(argv)
    if "feature_type" not in cli_args or "spool_dir" not in cli_args:
        raise SystemExit(SERVE_USAGE)
    families = parse_feature_types(cli_args.feature_type)
    # file sinks only: responses point at artifacts, and the idempotent
    # skip + journals need per-family output dirs (print has neither)
    if cli_args.get("on_extraction", "save_numpy") == "print":
        raise SystemExit("serve needs a file sink "
                         "(on_extraction=save_numpy or save_pickle): "
                         "responses reference artifact files")
    cli_args.setdefault("on_extraction", "save_numpy")
    from .cli import _maybe_init_distributed
    if len(families) > 1:
        per_family = load_multi_config(families, cli_args)
        args = per_family[families[0]]
        # the user-level output root, captured BEFORE sanity_check
        # namespaces each family's path beneath it (cli.py does the same)
        out_root = str(args.output_path)
        _maybe_init_distributed(args)
        # no launch-time corpus: videos arrive per request
        sanity_check_multi(per_family, require_videos=False)
    else:
        per_family = None
        args = load_config(cli_args.feature_type, cli_args)
        _maybe_init_distributed(args)
        sanity_check(args, require_videos=False)
        out_root = str(args.output_path)
    from .compile_cache import configure_build_dir
    configure_build_dir(args)

    # fault-injection plan (utils/inject.py): armed for the server's
    # lifetime; VFT_INJECT overrides the config key
    from .utils import inject
    inject_plan = inject.arm_for_run(args.get("inject"))

    loop = ServeLoop(args, per_family=per_family, out_root=out_root)
    # SIGTERM/SIGINT: finish in-flight requests, final heartbeat, exit 143
    if threading.current_thread() is threading.main_thread():
        def _on_term(signo, frame):
            print("serve: SIGTERM — draining in-flight requests")
            loop.stop()
        signal.signal(signal.SIGTERM, _on_term)
    try:
        rc = loop.run()
    finally:
        if inject_plan is not None:
            print(inject_plan.summary())
        inject.disarm()
    if rc:
        raise SystemExit(rc)


def main(argv: Optional[List[str]] = None) -> None:
    serve_main(argv)


if __name__ == "__main__":
    main()
