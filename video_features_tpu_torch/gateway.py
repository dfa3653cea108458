"""The HTTP gateway: the network front door of the spool (port of
``video_features_tpu/gateway.py``).

Without it every client mounts the spool (``serve.py``). The gateway is
another spool client, on the stdlib ``ThreadingHTTPServer``, built to shed
load rather than collapse:

  - **tenants** from an API-key table (``tenants.yml``: key -> tenant,
    quota, priority class), minted into the request id as
    ``{tenant}-{rid}``, so every span, digest, journal record and alert the
    request produces names its tenant (``telemetry/context.py tenant_of``);
  - **admission**: per-tenant token buckets and in-flight quotas answer
    ``429`` with a computed ``Retry-After``; a full edge queue or a dead
    backend (spool depth and heartbeat liveness) answers ``503``. Accepted
    requests wait in bounded per-priority queues and are released into the
    spool by smooth weighted fair share (high/normal/low = 4/2/1) while the
    spool backlog is under ``gateway_spool_bound``;
  - **deadlines**: a client ``timeout_s`` becomes an absolute ``deadline``
    from the gateway's clock; the gateway expires requests still queued at
    the edge, ``ServeLoop`` cancels expired ones at claim and between
    videos, and the gateway sweeps submitted requests unanswered past
    ``deadline + gateway_expire_grace_s``, so every accepted request
    reaches exactly one terminal record;
  - **idempotent ingestion**: uploads are stored in ``{spool}/inbox/`` by
    sha256, so a retried identical upload gets the stored path back
    (``dedup: true``);
  - **injection sites** ``gateway.read`` (the body read: ``torn``,
    ``stall`` or a raise) and ``gateway.spool_submit`` (``drop`` or a raise;
    ``utils/inject.py``); SIGTERM stops accepting, flushes the accepted
    requests into the spool and exits 143.

**HTTP API** (JSON bodies unless noted):

  ==========================================  ===========================
  ``POST /v1/extract``                        ``{"video_paths": [...]}``
                                              or ``{"video_urls": [...]}``
                                              (+ optional ``timeout_s``)
                                              -> 202 ``{"id": ...}``;
                                              429/503 when shedding
  ``POST /v1/upload?name=clip.mp4``           raw bytes -> 201/200
                                              ``{"path", "sha256",
                                              "dedup"}``
  ``GET /v1/requests/{id}``                   the terminal record, else
                                              202 with the queue state
  ``GET /healthz``                            gateway + backend liveness
  ``GET /metrics``                            Prometheus text
  ==========================================  ===========================

Auth is ``X-API-Key: <key>`` (or ``Authorization: Bearer <key>``); without
a tenant table the gateway runs open as the one tenant ``anon``. Every
admission decision appends to ``{spool}/_gateway_{host_id}.jsonl``
(accepted / rejected / shed / submitted / responded / expired / upload),
the ledger the audit reconciles against the spool.

Run it: ``python -m video_features_tpu_torch gateway spool_dir=/srv/vft
gateway_port=8080 gateway_tenants=tenants.yml``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import signal
import socket
import sys
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from . import serve

INBOX_DIR = "inbox"
GATEWAY_JOURNAL_PREFIX = "_gateway_"
GATEWAY_JOURNAL_GLOB = GATEWAY_JOURNAL_PREFIX + "*.jsonl"

#: journal record schema (one line per admission/lifecycle event)
JOURNAL_SCHEMA = "vft.gateway_event/1"

#: priority classes and their fair-share weights: at sustained
#: saturation the release order converges to 4:2:1 — high-priority
#: tenants degrade LAST, but low never starves (smooth weighted RR)
PRIORITY_WEIGHTS: Dict[str, int] = {"high": 4, "normal": 2, "low": 1}

#: per-tenant defaults when the table omits a field (and the whole
#: ``anon`` tenant when no table is configured)
TENANT_DEFAULTS = {"rate_rps": 50.0, "burst": 100.0,
                   "max_inflight": 64, "priority": "normal"}

_TENANT_NAME_RE = re.compile(r"[a-z0-9_]+\Z")


class Tenant:
    """One row of the API-key table."""

    __slots__ = ("name", "key", "rate_rps", "burst", "max_inflight",
                 "priority")

    def __init__(self, name: str, key: Optional[str], *,
                 rate_rps: float, burst: float, max_inflight: int,
                 priority: str) -> None:
        self.name = name
        self.key = key
        self.rate_rps = float(rate_rps)
        self.burst = float(burst)
        self.max_inflight = int(max_inflight)
        self.priority = str(priority)


def load_tenant_table(path: Optional[str]) -> Dict[str, Tenant]:
    """Parse ``tenants.yml`` into ``{api_key: Tenant}`` — validated
    loudly at launch (a typo'd quota must not silently admit the world).
    ``None`` -> the open single-tenant table (``anon``, keyless).

    Format::

        tenants:
          alpha:
            key: alpha-secret-1     # required per tenant
            rate_rps: 10            # token refill per second
            burst: 20               # bucket capacity
            max_inflight: 8         # accepted-but-unfinished bound
            priority: high          # high | normal | low
    """
    if not path:
        anon = Tenant("anon", None, **TENANT_DEFAULTS)
        return {None: anon}  # type: ignore[dict-item]
    import yaml
    with open(path, encoding="utf-8") as f:
        doc = yaml.safe_load(f) or {}
    rows = doc.get("tenants")
    if not isinstance(rows, dict) or not rows:
        raise ValueError(f"{path}: expected a top-level 'tenants:' "
                         "mapping with at least one tenant")
    out: Dict[str, Tenant] = {}
    for name, row in rows.items():
        name = str(name)
        if not _TENANT_NAME_RE.match(name):
            raise ValueError(
                f"{path}: tenant name {name!r} must match [a-z0-9_]+ — "
                "the name is the request-id prefix and '-' is the "
                "separator (telemetry/context.py tenant_of)")
        row = dict(row or {})
        key = row.get("key")
        if not key or not isinstance(key, str):
            raise ValueError(f"{path}: tenant {name!r} needs a string "
                             "'key' (the API key clients present)")
        if key in out:
            raise ValueError(f"{path}: API key of tenant {name!r} "
                             f"duplicates tenant {out[key].name!r}")
        merged = {**TENANT_DEFAULTS,
                  **{k: row[k] for k in TENANT_DEFAULTS if k in row}}
        if merged["priority"] not in PRIORITY_WEIGHTS:
            raise ValueError(
                f"{path}: tenant {name!r}: priority "
                f"{merged['priority']!r} must be one of "
                f"{'/'.join(PRIORITY_WEIGHTS)}")
        if float(merged["rate_rps"]) <= 0 or float(merged["burst"]) < 1:
            raise ValueError(f"{path}: tenant {name!r}: need "
                             "rate_rps > 0 and burst >= 1")
        if int(merged["max_inflight"]) < 1:
            raise ValueError(f"{path}: tenant {name!r}: need "
                             "max_inflight >= 1")
        out[key] = Tenant(name, key, rate_rps=merged["rate_rps"],
                          burst=merged["burst"],
                          max_inflight=merged["max_inflight"],
                          priority=merged["priority"])
    return out


def validate_gateway_args(args: Dict[str, Any]) -> None:
    """Launch-time validation of the ``gateway_*`` keys (called from
    ``sanity_check`` when any is present, and by ``gateway_main``) —
    same discipline as every other config family: a typo fails HERE."""
    gt = args.get("gateway_tenants")
    if gt is not None:
        if not isinstance(gt, str):
            raise ValueError(f"gateway_tenants={gt!r}: expected a "
                             "tenants.yml path or null (null = open "
                             "single-tenant mode)")
        load_tenant_table(gt)  # raises naming the bad row
    port = args.get("gateway_port")
    if port is not None and (not isinstance(port, int)
                             or not 0 <= int(port) <= 65535):
        raise ValueError(f"gateway_port={port!r}: need an int in "
                         "[0, 65535] (0 = ephemeral, tests)")
    host = args.get("gateway_host")
    if host is not None and not isinstance(host, str):
        raise ValueError(f"gateway_host={host!r}: need a bind address "
                         "string (default 127.0.0.1) or null")
    for key, lo in (("gateway_max_queued", 1), ("gateway_spool_bound", 1),
                    ("gateway_max_body_mb", 1)):
        v = args.get(key)
        if v is not None and int(v) < lo:
            raise ValueError(f"{key}={v!r}: need an int >= {lo}")
    for key in ("gateway_poll_interval_s", "gateway_expire_grace_s",
                "gateway_default_timeout_s"):
        v = args.get(key)
        if v is not None and float(v) <= 0:
            raise ValueError(f"{key}={v!r}: need a float > 0 (or null)")


class TokenBucket:
    """Deterministic token bucket: ``capacity=burst`` tokens refilled at
    ``rate_rps``; ``try_take`` either takes one or reports how long
    until one exists — the number the 429 ``Retry-After`` header
    carries, so well-behaved clients back off exactly enough."""

    def __init__(self, rate_rps: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate = float(rate_rps)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> Tuple[bool, float]:
        with self._lock:
            now = self.clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate


class _Pending:
    """One accepted request waiting for fair-share release."""

    __slots__ = ("rid", "tenant", "video_paths", "deadline", "accepted_at",
                 "klass")

    def __init__(self, rid: str, tenant: Tenant, video_paths: List[str],
                 deadline: Optional[float]) -> None:
        self.rid = rid
        self.tenant = tenant
        self.video_paths = list(video_paths)
        self.deadline = deadline
        self.accepted_at = time.time()
        self.klass = tenant.priority


class GatewayServer:
    """The ingress: construct, :meth:`start`, :meth:`stop` (drains).

    Separated from :func:`gateway_main` so tests and the smoke gate can
    drive it in-process on an ephemeral port, exactly like ServeLoop.
    """

    def __init__(self, args: Dict[str, Any],
                 tenants: Optional[Dict[str, Tenant]] = None) -> None:
        self.args = args
        self.spool_dir = str(args["spool_dir"])
        serve.ensure_spool(self.spool_dir)
        self.inbox_dir = os.path.join(self.spool_dir, INBOX_DIR)
        os.makedirs(self.inbox_dir, exist_ok=True)
        self.tenants = (tenants if tenants is not None
                        else load_tenant_table(args.get("gateway_tenants")))
        self.open_mode = None in self.tenants  # keyless anon table
        self.max_queued = int(args.get("gateway_max_queued") or 256)
        self.spool_bound = int(args.get("gateway_spool_bound")
                               or args.get("serve_max_pending") or 64)
        self.poll_s = float(args.get("gateway_poll_interval_s") or 0.25)
        self.expire_grace_s = float(args.get("gateway_expire_grace_s")
                                    or 10.0)
        self.default_timeout_s = args.get("gateway_default_timeout_s")
        self.max_body = int(args.get("gateway_max_body_mb") or 512) << 20

        self._stop = threading.Event()
        self._drained = threading.Event()
        self._lock = threading.Lock()
        self._state = "warming"
        #: {class: deque[_Pending]} — bounded by max_queued in total
        self._queues: Dict[str, deque] = {c: deque()
                                          for c in PRIORITY_WEIGHTS}
        self._credit: Dict[str, float] = {c: 0.0 for c in PRIORITY_WEIGHTS}
        #: accepted-but-not-terminal requests: rid -> state dict
        self._open: Dict[str, dict] = {}
        self._inflight: Dict[str, int] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._tenant_tallies: Dict[str, Dict[str, int]] = {}

        # telemetry: heartbeat + journal homed on the SPOOL, like the
        # servers — one fleet-report pass sees gateway and backends alike
        from .cache import _plain
        from .telemetry.recorder import TelemetryRecorder
        host_id = f"gw-{socket.gethostname()}-{os.getpid()}"
        self.host_id = host_id
        self.recorder = TelemetryRecorder(
            self.spool_dir,
            run_config=_plain(dict(args)),
            feature_type="gateway",
            interval_s=float(args.get("metrics_interval_s") or 5.0),
            host_id=host_id)
        self.recorder.extra_sections["gateway"] = self._gateway_section
        self.journal_path = os.path.join(
            self.spool_dir, f"{GATEWAY_JOURNAL_PREFIX}"
            f"{re.sub(r'[^A-Za-z0-9._-]+', '-', host_id)}.jsonl")

        port = int(args.get("gateway_port") or 0)
        host = str(args.get("gateway_host") or "127.0.0.1")
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.gateway = self  # type: ignore[attr-defined]
        self.httpd.daemon_threads = True
        self.port = int(self.httpd.server_address[1])
        self._http_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None

    # -- journal / tallies --------------------------------------------------
    def _j(self, event: str, **fields: Any) -> None:
        from .telemetry import jsonl
        rec = {"schema": JOURNAL_SCHEMA, "event": event,
               "time": round(time.time(), 3)}
        rec.update({k: v for k, v in fields.items() if v is not None})
        jsonl.append_jsonl(self.journal_path, rec)

    def _tally(self, tenant: str, key: str, n: int = 1) -> None:
        with self._lock:
            t = self._tenant_tallies.setdefault(
                tenant, {"accepted": 0, "rejected": 0, "shed": 0,
                         "responded": 0, "expired": 0})
            t[key] = t.get(key, 0) + n
        self.recorder.registry.counter(
            "vft_gateway_requests_total", tenant=tenant, outcome=key).inc(n)

    def _gateway_section(self) -> dict:
        with self._lock:
            queued = {c: len(q) for c, q in self._queues.items()}
            tenants = {t: {**v, "inflight": self._inflight.get(t, 0)}
                       for t, v in sorted(self._tenant_tallies.items())}
            open_count = len(self._open)
            state = self._state
        return {"state": state, "port": self.port,
                "queued": queued, "queued_total": sum(queued.values()),
                "open_requests": open_count,
                "spool_pending": self._spool_pending(),
                "tenants": tenants}

    # -- admission ----------------------------------------------------------
    def tenant_for_key(self, key: Optional[str]) -> Optional[Tenant]:
        if self.open_mode:
            return self.tenants[None]  # type: ignore[index]
        if key is None:
            return None
        return self.tenants.get(key)

    def _bucket(self, tenant: Tenant) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant.name)
            if b is None:
                b = self._buckets[tenant.name] = TokenBucket(
                    tenant.rate_rps, tenant.burst)
            return b

    def _spool_pending(self) -> int:
        try:
            return sum(1 for n in os.listdir(
                os.path.join(self.spool_dir, serve.REQUESTS_DIR))
                if n.endswith(".json"))
        except OSError:
            return 0

    def _backlog_wait_s(self, klass: str) -> float:
        """Estimated seconds until the release loop drains what is
        queued ahead of a new ``klass`` request: queue depth over the
        class's weighted-fair share of the per-tick spool budget. This
        is the backlog half of an honest 429 Retry-After — refill alone
        tells a client when it has a TOKEN, not when the edge queue has
        ROOM, so under backlog refill-only retries thunder back into
        the same full queue."""
        with self._lock:
            depths = {c: len(q) for c, q in self._queues.items()}
        qlen = depths.get(klass, 0)
        if not qlen:
            return 0.0
        active = [c for c, d in depths.items() if d]
        share = PRIORITY_WEIGHTS[klass] / float(
            sum(PRIORITY_WEIGHTS[c] for c in active))
        per_tick = max(1.0, self.spool_bound * share)
        return qlen / per_tick * self.poll_s

    def _shed_reason(self) -> Optional[str]:
        """503-worthy overload, from signals the spool already exports:
        a full edge queue, or a backend the heartbeats say is DEAD
        (exited/stalled). 'absent' (no server started yet) is NOT shed —
        the spool is the decoupling; requests queue and deadlines bound
        the wait."""
        with self._lock:
            if sum(len(q) for q in self._queues.values()) >= \
                    self.max_queued:
                return "queue_full"
        state = serve.server_state(self.spool_dir).get("state")
        if state in ("exited", "stalled"):
            return f"backend_{state}"
        return None

    def admit(self, tenant: Tenant, video_paths: List[str],
              timeout_s: Optional[float]
              ) -> Tuple[int, dict, Dict[str, str]]:
        """The whole admission decision for one extract request:
        ``(http_status, body, extra_headers)``. 202 accepts; 429 is a
        per-tenant quota no (rate or in-flight, with Retry-After); 503
        is systemic shed. Every outcome is journaled."""
        rid = f"{tenant.name}-{uuid.uuid4().hex[:12]}"
        ok, retry_after = self._bucket(tenant).try_take()
        if not ok:
            retry = max(1, int(retry_after
                               + self._backlog_wait_s(tenant.priority)
                               + 0.999))
            self._tally(tenant.name, "rejected")
            self._j("rejected", id=rid, tenant=tenant.name, reason="rate",
                    retry_after_s=retry)
            return (429,
                    {"error": f"tenant {tenant.name} over rate limit "
                              f"({tenant.rate_rps}/s, burst "
                              f"{tenant.burst:g}); retry later",
                     "retry_after_s": retry},
                    {"Retry-After": str(retry)})
        with self._lock:
            inflight = self._inflight.get(tenant.name, 0)
        if inflight >= tenant.max_inflight:
            retry = max(1, int(self.poll_s * 4
                               + self._backlog_wait_s(tenant.priority)
                               + 0.999))
            self._tally(tenant.name, "rejected")
            self._j("rejected", id=rid, tenant=tenant.name,
                    reason="inflight", retry_after_s=retry)
            return (429,
                    {"error": f"tenant {tenant.name} at max_inflight="
                              f"{tenant.max_inflight}; retry later",
                     "retry_after_s": retry},
                    {"Retry-After": str(retry)})
        reason = self._shed_reason()
        if reason:
            retry = max(1, int(self.poll_s * 8 + 0.999))
            self._tally(tenant.name, "shed")
            self._j("shed", id=rid, tenant=tenant.name, reason=reason,
                    retry_after_s=retry)
            return (503,
                    {"error": f"load shed ({reason}); retry later",
                     "retry_after_s": retry},
                    {"Retry-After": str(retry)})
        timeout = (timeout_s if timeout_s is not None
                   else self.default_timeout_s)
        # deadline from the GATEWAY clock + the requested DURATION:
        # client wall-clock skew cannot expire a request early
        deadline = (round(time.time() + float(timeout), 3)
                    if timeout is not None else None)
        p = _Pending(rid, tenant, video_paths, deadline)
        with self._lock:
            self._queues[p.klass].append(p)
            self._inflight[tenant.name] = \
                self._inflight.get(tenant.name, 0) + 1
            self._open[rid] = {"state": "queued", "tenant": tenant.name,
                               "deadline": deadline}
        self._tally(tenant.name, "accepted")
        self._j("accepted", id=rid, tenant=tenant.name, klass=p.klass,
                videos=len(video_paths), deadline=deadline)
        return (202, {"id": rid, "status": "queued",
                      "class": p.klass, "deadline": deadline}, {})

    # -- ingestion ----------------------------------------------------------
    def store_upload(self, tenant: Tenant, data: bytes,
                     name: Optional[str]) -> Tuple[int, dict]:
        """Content-addressed inbox store: sha256 names the file, so a
        retried identical upload is a dedup hit — never duplicate bytes,
        never duplicate downstream work (the feature cache keys on the
        same content hash)."""
        from .utils.sinks import _write_bytes_atomic
        sha = hashlib.sha256(data).hexdigest()
        ext = ""
        if name:
            suffix = os.path.splitext(os.path.basename(str(name)))[1]
            if re.match(r"\.[A-Za-z0-9]{1,8}\Z", suffix or ""):
                ext = suffix.lower()
        path = os.path.join(self.inbox_dir, f"{sha[:16]}{ext}")
        if os.path.exists(path):
            self._j("upload", tenant=tenant.name, path=path, sha256=sha,
                    bytes=len(data), dedup=True)
            self.recorder.registry.counter(
                "vft_gateway_upload_dedup_total", tenant=tenant.name).inc()
            return 200, {"path": path, "sha256": sha, "dedup": True}
        _write_bytes_atomic(path, data)
        self._j("upload", tenant=tenant.name, path=path, sha256=sha,
                bytes=len(data), dedup=False)
        self.recorder.registry.counter(
            "vft_gateway_upload_stored_total", tenant=tenant.name).inc()
        return 201, {"path": path, "sha256": sha, "dedup": False}

    def fetch_url(self, tenant: Tenant, url: str) -> str:
        """URL-fetch ingestion into the same content-addressed inbox
        (``file://`` and ``http(s)://``). The body streams through the
        ``gateway.read`` injection site like a client upload."""
        from urllib.request import urlopen
        chunks: List[bytes] = []
        total = 0
        with urlopen(url, timeout=30) as r:
            while True:
                _fire_read(total)
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                total += len(chunk)
                if total > self.max_body:
                    raise ValueError(f"{url}: body over "
                                     f"{self.max_body >> 20} MB")
                chunks.append(chunk)
        name = os.path.basename(url.split("?", 1)[0]) or None
        _code, body = self.store_upload(tenant, b"".join(chunks), name)
        return str(body["path"])

    # -- release (weighted fair share) --------------------------------------
    def _pick_class(self) -> Optional[str]:
        """Smooth weighted round-robin over the NON-EMPTY classes:
        credits accumulate by weight, the richest class releases and
        pays the total back — 4:2:1 over any window, no starvation.
        Caller holds the lock."""
        nonempty = [c for c in PRIORITY_WEIGHTS if self._queues[c]]
        if not nonempty:
            return None
        total = sum(PRIORITY_WEIGHTS[c] for c in nonempty)
        best = None
        for c in nonempty:
            self._credit[c] += PRIORITY_WEIGHTS[c]
            if best is None or self._credit[c] > self._credit[best]:
                best = c
        self._credit[best] -= total
        return best

    def _release_some(self) -> None:
        """Move queued requests into the spool while the backlog is
        under ``gateway_spool_bound`` — the spool never grows past the
        admission bound, so a slow backend backs pressure up to the
        edge (where it becomes 429/503) instead of into an unbounded
        directory."""
        while not self._stop.is_set():
            if self._spool_pending() >= self.spool_bound:
                return
            with self._lock:
                klass = self._pick_class()
                p = self._queues[klass].popleft() if klass else None
            if p is None:
                return
            if p.deadline is not None and time.time() >= p.deadline:
                self._expire_edge(p.rid, p.tenant.name, p.deadline,
                                  "queued")
                continue
            if not self._submit(p):
                with self._lock:
                    self._queues[p.klass].appendleft(p)
                return  # transient submit failure: retry next pump pass

    def _submit(self, p: _Pending) -> bool:
        from .utils import inject
        try:
            fault = inject.fire("gateway.spool_submit", request=p.rid)
            if fault is not None and fault.kind == "drop":
                # the submit is LOST after we believe it landed (a dying
                # NFS client, a torn rename): the deadline sweep is the
                # recovery path — past deadline+grace with no terminal
                # record, the gateway writes the expired record itself
                pass
            else:
                serve.submit_request(self.spool_dir, p.video_paths,
                                     request_id=p.rid, deadline=p.deadline)
        except OSError as e:
            self._j("submit_error", id=p.rid, tenant=p.tenant.name,
                    error=f"{type(e).__name__}: {e}")
            return False
        with self._lock:
            st = self._open.get(p.rid)
            if st is not None:
                st["state"] = "submitted"
        self._j("submitted", id=p.rid, tenant=p.tenant.name)
        return True

    # -- terminal bookkeeping ------------------------------------------------
    def _close(self, rid: str, tenant: str, outcome: str,
               status: Optional[str] = None) -> None:
        with self._lock:
            self._open.pop(rid, None)
            if self._inflight.get(tenant, 0) > 0:
                self._inflight[tenant] -= 1
        self._tally(tenant, outcome)
        self._j(outcome, id=rid, tenant=tenant, status=status)

    def _expire_edge(self, rid: str, tenant: str,
                     deadline: Optional[float], where: str) -> None:
        """Terminal ``deadline_exceeded`` written BY THE GATEWAY — for
        requests that never reached a server (still queued at the edge,
        withdrawn from the spool, or lost in flight)."""
        from .telemetry import jsonl
        rec = {"schema": serve.RESPONSE_SCHEMA, "id": rid,
               "status": "deadline_exceeded", "tenant": tenant,
               "time": round(time.time(), 3), "deadline": deadline,
               "expired_at": where, "videos": {}, "processed": 0}
        jsonl.write_json_atomic(
            os.path.join(self.spool_dir, serve.EXPIRED_DIR,
                         f"{rid}.json"), rec)
        self._close(rid, tenant, "expired", status="deadline_exceeded")

    def _sweep(self) -> None:
        """One pump pass of lifecycle bookkeeping: expire edge-queued
        requests past deadline, reap terminal records, and recover
        submitted requests the backend will never answer (withdraw from
        ``requests/`` at deadline, or declare lost past
        ``deadline + gateway_expire_grace_s``)."""
        now = time.time()
        with self._lock:
            expired_edge = []
            for q in self._queues.values():
                keep = deque()
                for p in q:
                    if p.deadline is not None and now >= p.deadline:
                        expired_edge.append(p)
                    else:
                        keep.append(p)
                q.clear()
                q.extend(keep)
            open_now = [(rid, dict(st)) for rid, st in self._open.items()
                        if st["state"] == "submitted"]
        for p in expired_edge:
            self._expire_edge(p.rid, p.tenant.name, p.deadline, "queued")
        for rid, st in open_now:
            term = serve.read_terminal(self.spool_dir, rid)
            if term is not None:
                outcome = ("expired"
                           if term.get("status") == "deadline_exceeded"
                           else "responded")
                self._close(rid, st["tenant"], outcome,
                            status=term.get("status"))
                continue
            deadline = st.get("deadline")
            if deadline is None or now < float(deadline):
                continue
            # past deadline with no terminal record: withdraw the spool
            # request so no server starts it (unlink is atomic against
            # the claim rename — exactly one side wins)
            try:
                os.unlink(os.path.join(self.spool_dir, serve.REQUESTS_DIR,
                                       f"{rid}.json"))
                self._expire_edge(rid, st["tenant"], float(deadline),
                                  "spooled")
                continue
            except OSError:
                pass  # claimed (server will expire it) — or lost
            if now >= float(deadline) + self.expire_grace_s:
                if serve.read_terminal(self.spool_dir, rid) is None:
                    # lost in flight (dropped submit, server died holding
                    # the claim): the gateway is the terminal writer of
                    # last resort, so the caller ALWAYS gets an answer
                    self._expire_edge(rid, st["tenant"], float(deadline),
                                      "lost")

    # -- lifecycle ----------------------------------------------------------
    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                self._release_some()
                self._sweep()
            except Exception as e:  # the pump must survive anything
                print(f"gateway: pump error: {type(e).__name__}: {e}",
                      file=sys.stderr)
            self._stop.wait(self.poll_s)

    def start(self) -> "GatewayServer":
        self.recorder.start()
        with self._lock:
            self._state = "ready"
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="vft-gateway-http", daemon=True)
        self._http_thread.start()
        self._pump_thread = threading.Thread(
            target=self._pump, name="vft-gateway-pump", daemon=True)
        self._pump_thread.start()
        print(f"gateway: ready — http://{self.httpd.server_address[0]}"
              f":{self.port} spool={self.spool_dir} "
              f"tenants={'open' if self.open_mode else len(self.tenants)}")
        return self

    def stop(self) -> None:
        """SIGTERM semantics: stop ACCEPTING (the listener closes — new
        connections are refused, never silently dropped mid-queue),
        flush every accepted-but-unsubmitted request into the spool
        (they were promised a 202; the backend + deadlines own them
        now), write the final heartbeat, and let :meth:`run` exit 143."""
        if self._stop.is_set():
            return
        with self._lock:
            self._state = "draining"
        if self._http_thread is not None:
            self.httpd.shutdown()  # blocks until serve_forever returns
        self.httpd.server_close()
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10)
        # flush in-flight submissions, deadline-expired ones excepted
        while True:
            with self._lock:
                klass = next((c for c in PRIORITY_WEIGHTS
                              if self._queues[c]), None)
                p = self._queues[klass].popleft() if klass else None
            if p is None:
                break
            if p.deadline is not None and time.time() >= p.deadline:
                self._expire_edge(p.rid, p.tenant.name, p.deadline,
                                  "queued")
            else:
                self._submit(p)
        self._j("drain", open=len(self._open))
        with self._lock:
            self._state = "exited"
        self.recorder.close()
        self._drained.set()

    def run(self) -> int:
        """Block until signalled (gateway_main wires SIGTERM/SIGINT to
        :meth:`stop`); returns 143 — the fleet's preemption contract."""
        self.start()
        self._stop.wait()
        self._drained.wait(timeout=60)
        return 143


# -- injection helper ---------------------------------------------------------

def _fire_read(progress: int) -> Optional[str]:
    """The ``gateway.read`` chaos site, shared by upload-body reads and
    URL fetches: raise-kind faults raise here (EIO mid-body); ``torn``
    tells the caller to cut the stream short; ``stall`` simulates the
    slow client by sleeping briefly before the read continues."""
    from .utils import inject
    fault = inject.fire("gateway.read", at_byte=progress)
    if fault is None:
        return None
    if fault.kind == "stall":
        time.sleep(0.2)
        return None
    return fault.kind


# -- the HTTP layer -----------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "vft-gateway/1"
    protocol_version = "HTTP/1.1"

    @property
    def gw(self) -> GatewayServer:
        return self.server.gateway  # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # admission outcomes are journaled; stdio stays quiet

    # -- plumbing -----------------------------------------------------------
    def _send(self, code: int, obj: dict,
              headers: Optional[Dict[str, str]] = None) -> None:
        body = (json.dumps(obj, sort_keys=True) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client hung up; the journal already has the truth

    def _tenant(self) -> Optional[Tenant]:
        key = self.headers.get("X-API-Key")
        if key is None:
            auth = self.headers.get("Authorization") or ""
            if auth.startswith("Bearer "):
                key = auth[len("Bearer "):].strip()
        tenant = self.gw.tenant_for_key(key)
        if tenant is None:
            self._send(401, {"error": "unknown or missing API key "
                                      "(X-API-Key / Authorization: "
                                      "Bearer)"})
        return tenant

    def _read_body(self) -> Optional[bytes]:
        """The request body, through the ``gateway.read`` chaos site.
        Returns None after responding (411/413/400) on any read
        problem — a torn client body is a CLIENT error, answered
        explicitly, never a half-ingested request."""
        length = self.headers.get("Content-Length")
        if length is None:
            self._send(411, {"error": "Content-Length required"})
            return None
        length = int(length)
        if length > self.gw.max_body:
            self._send(413, {"error": f"body over "
                                      f"{self.gw.max_body >> 20} MB"})
            return None
        try:
            kind = _fire_read(0)
            if kind == "torn":
                data = self.rfile.read(max(1, length // 2))
            else:
                data = self.rfile.read(length)
        except OSError as e:
            self._send(400, {"error": f"body read failed: {e}"})
            return None
        if len(data) != length:
            self._send(400, {"error": f"torn body: read {len(data)} of "
                                      f"{length} bytes — retry the "
                                      "upload (identical bytes dedup)"})
            return None
        return data

    # -- routes -------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        from urllib.parse import urlparse
        path = urlparse(self.path).path
        if path == "/healthz":
            gw = self.gw
            self._send(200, {"gateway": gw._gateway_section(),
                             "backend": serve.server_state(gw.spool_dir)})
            return
        if path == "/metrics":
            from .telemetry.metrics import prometheus_text
            text = prometheus_text(self.gw.recorder.registry.to_dict())
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        m = re.match(r"/v1/requests/([A-Za-z0-9_-]+)\Z", path)
        if m:
            tenant = self._tenant()
            if tenant is None:
                return
            rid = m.group(1)
            from .telemetry.context import tenant_of
            owner = tenant_of(rid)
            if owner != tenant.name and \
                    not (owner is None and self.gw.open_mode):
                # tenant isolation: one tenant can never observe (or
                # even probe the existence of) another tenant's request
                self._send(403, {"error": "request belongs to another "
                                          "tenant"})
                return
            term = serve.read_terminal(self.gw.spool_dir, rid)
            if term is not None:
                self._send(200, term)
                return
            with self.gw._lock:
                st = self.gw._open.get(rid)
            if st is not None:
                self._send(202, {"id": rid, "status": st["state"],
                                 "deadline": st.get("deadline")})
                return
            self._send(404, {"error": f"unknown request {rid}"})
            return
        self._send(404, {"error": f"no route {path}"})

    def do_POST(self) -> None:  # noqa: N802
        from urllib.parse import parse_qs, urlparse
        parsed = urlparse(self.path)
        tenant = self._tenant()
        if tenant is None:
            return
        if parsed.path == "/v1/upload":
            ok, retry_after = self.gw._bucket(tenant).try_take()
            if not ok:
                retry = max(1, int(retry_after + 0.999))
                self.gw._tally(tenant.name, "rejected")
                self.gw._j("rejected", tenant=tenant.name,
                           reason="rate_upload", retry_after_s=retry)
                self._send(429, {"error": "over rate limit; retry later",
                                 "retry_after_s": retry},
                           {"Retry-After": str(retry)})
                return
            data = self._read_body()
            if data is None:
                return
            want = self.headers.get("X-Content-SHA256")
            if want and hashlib.sha256(data).hexdigest() != want.lower():
                self._send(400, {"error": "X-Content-SHA256 mismatch — "
                                          "body corrupted in transit"})
                return
            name = (parse_qs(parsed.query).get("name") or [None])[0]
            code, body = self.gw.store_upload(tenant, data, name)
            self._send(code, body)
            return
        if parsed.path == "/v1/extract":
            data = self._read_body()
            if data is None:
                return
            try:
                req = json.loads(data.decode("utf-8"))
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            paths = [str(v) for v in req.get("video_paths") or []]
            urls = [str(u) for u in req.get("video_urls") or []]
            if not paths and not urls:
                self._send(400, {"error": "need video_paths and/or "
                                          "video_urls"})
                return
            timeout_s = req.get("timeout_s")
            if timeout_s is not None and float(timeout_s) <= 0:
                self._send(400, {"error": f"timeout_s={timeout_s!r}: "
                                          "need a float > 0 or null"})
                return
            for url in urls:
                try:
                    paths.append(self.gw.fetch_url(tenant, url))
                except Exception as e:
                    self._send(502, {"error": f"fetch {url!r} failed: "
                                              f"{type(e).__name__}: {e}"})
                    return
            code, body, headers = self.gw.admit(
                tenant, paths,
                float(timeout_s) if timeout_s is not None else None)
            self._send(code, body, headers)
            return
        self._send(404, {"error": f"no route {parsed.path}"})


# -- entry point --------------------------------------------------------------

def gateway_main(argv: Optional[List[str]] = None) -> None:
    """Entry point: ``python -m video_features_tpu_torch gateway
    spool_dir=<dir> [key=value ...]``."""
    from .config import parse_dotlist
    argv = list(sys.argv[1:] if argv is None else argv)
    cli_args = parse_dotlist(argv)
    if "spool_dir" not in cli_args:
        raise SystemExit(
            "Usage: python -m video_features_tpu_torch gateway "
            "spool_dir=<dir> [gateway_port=8080] "
            "[gateway_tenants=tenants.yml] [key=value ...]")
    validate_gateway_args(cli_args)
    from .utils import inject
    inj = cli_args.get("inject")
    if inj is not None:
        inject.parse_plan(str(inj))  # fail a typo'd plan at launch
    inject_plan = inject.arm_for_run(inj)
    gw = GatewayServer(cli_args)
    if threading.current_thread() is threading.main_thread():
        def _on_term(signo, frame):
            print("gateway: SIGTERM — draining")
            threading.Thread(target=gw.stop, daemon=True).start()
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    try:
        rc = gw.run()
    finally:
        if inject_plan is not None:
            print(inject_plan.summary())
        inject.disarm()
    if rc:
        raise SystemExit(rc)


def main(argv: Optional[List[str]] = None) -> None:
    gateway_main(argv)


if __name__ == "__main__":
    main()
