"""The storage lifecycle plane: usage accounting and journaled eviction
(port of ``video_features_tpu/gc.py``).

    python -m video_features_tpu_torch gc /shared/out            # once
    python -m video_features_tpu_torch gc /shared/out --dry-run  # plan only
    python -m video_features_tpu_torch gc /shared/out --watch    # a daemon
    python -m video_features_tpu_torch gc /shared/out --quota-gb 50

Every durable plane the port writes grows without bound: the feature cache
(``cache.py``), the compile store of the ``nvcc`` build
(``compile_cache.py``), the spool's ``done/`` and ``expired/`` responses
(``serve.py``), the gateway's ``inbox/`` uploads (``gateway.py``), the
incident bundles (``telemetry/alerts.py``), the queue's ``quarantined/``
and ``.staging/`` (``parallel/queue.py``) and the append-only journals.
This module accounts their bytes per plane and per tenant and deletes only
what is recoverable or provably unreferenced, each delete journaled before
it happens, so a killed sweep leaves a tree that audits clean
(``audit.py``) and a rerun converges.

The safety rule of each plane, as in the JAX package:

  - **cache**: an evicted entry is a recoverable miss (the next run
    recomputes it bit for bit), so eviction is last-hit LRU (``cache.py``
    bumps an entry's mtime on every verified hit) under the byte quota,
    plus an optional age retention;
  - **compile**: an entry whose environment fingerprint
    (:func:`compile_cache.env_fingerprint`: torch, CUDA, ``nvcc``, the
    driver, the card and its ``sm_XX``, Python) is not this host's is a
    library no process here can load: pruned past retention. The entry
    this process attached (``compile_cache.active``) and the directory
    ``kernels/build.py`` loads from are never planned;
  - **spool**: a ``done/`` or ``expired/`` response goes only past
    retention and when no ``requests/`` or ``claimed/*/`` file holds its
    rid;
  - **inbox**: an upload goes only past retention and when no live
    request names it (dedup shares one blob among requests);
  - **incidents**: bundles expire past retention unless a ``pinned`` file
    is in them;
  - **quarantine**: ``_queue/quarantined/`` items expire past retention
    (the POISON journal record stays the evidence);
  - **staging**: only ``_queue/.staging/`` remnants whose item has a
    ``done/`` marker; the queue's own sweep recovers the others.

Every deletion appends one ``vft.gc_event/1`` record to
``_gc_{host}.jsonl`` under the root before the unlink (inject site
``gc.evict``: ``drop`` and ``kill`` leave a journaled path on disk, the
crash window; ``eio`` a counted error); a sweep fires ``gc.sweep``
(``stall``). The formats are the JAX package's, so JAX and port hosts
share one root.

``gc=true`` on a run attaches :class:`GcMonitor`: a heartbeat ``gc``
section and the ``vft_gc_*`` gauges, the tree walk refreshed at most once
per ``gc_interval_s`` (accounting only; eviction is this command's job).
The retained history samples the section and the ``disk_pressure`` rule
(``telemetry/alerts.py``) projects time-to-full from it. ``gc=false``
(the default) registers nothing. The ``gc``/``gc_*`` keys are validated by
:func:`validate_gc_args` from ``config.sanity_check``. The planes table
and the failure matrix: ``docs/storage.md``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .telemetry.jsonl import append_jsonl, read_jsonl

GC_JOURNAL_PREFIX = "_gc_"
GC_JOURNAL_GLOB = GC_JOURNAL_PREFIX + "*.jsonl"
GC_JOURNAL_SCHEMA = "vft.gc_event/1"

#: the accounted planes, in eviction-priority order (recoverable first)
PLANES = ("cache", "compile", "spool", "inbox", "incidents",
          "quarantine", "staging", "journals")

#: journal filenames accounted under the "journals" plane; never deleted
#: (each is an append-only state channel: history compacts itself, the
#: rest are the evidence)
_JOURNAL_GLOBS = ("_telemetry.jsonl", "_history_*.jsonl",
                  "_gateway_*.jsonl", "_failures.jsonl", "_health.jsonl",
                  "_alerts.jsonl", "_gc_*.jsonl")

_RETENTION_KEYS = ("gc_cache_retention_s", "gc_compile_retention_s",
                   "gc_spool_retention_s", "gc_inbox_retention_s",
                   "gc_incident_retention_s", "gc_quarantine_retention_s",
                   "gc_staging_retention_s")


def journal_filename(host_id: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(host_id))
    return f"{GC_JOURNAL_PREFIX}{safe}.jsonl"


# -- config ------------------------------------------------------------------

class GcConfig:
    """The resolved knobs: the quota in bytes, one retention per plane
    (None: that plane is only accounted), the ``--watch`` cadence."""

    def __init__(self, *, quota_gb: Optional[float] = None,
                 cache_retention_s: Optional[float] = None,
                 compile_retention_s: Optional[float] = None,
                 spool_retention_s: Optional[float] = None,
                 inbox_retention_s: Optional[float] = None,
                 incident_retention_s: Optional[float] = None,
                 quarantine_retention_s: Optional[float] = None,
                 staging_retention_s: Optional[float] = None,
                 interval_s: float = 300.0) -> None:
        self.quota_bytes = (int(float(quota_gb) * 1e9)
                            if quota_gb is not None else None)
        self.cache_retention_s = cache_retention_s
        self.compile_retention_s = compile_retention_s
        self.spool_retention_s = spool_retention_s
        self.inbox_retention_s = inbox_retention_s
        self.incident_retention_s = incident_retention_s
        self.quarantine_retention_s = quarantine_retention_s
        self.staging_retention_s = staging_retention_s
        self.interval_s = float(interval_s)

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "GcConfig":
        def opt(key: str) -> Optional[float]:
            v = args.get(key)
            return float(v) if v is not None else None

        return cls(quota_gb=opt("gc_quota_gb"),
                   cache_retention_s=opt("gc_cache_retention_s"),
                   compile_retention_s=opt("gc_compile_retention_s"),
                   spool_retention_s=opt("gc_spool_retention_s"),
                   inbox_retention_s=opt("gc_inbox_retention_s"),
                   incident_retention_s=opt("gc_incident_retention_s"),
                   quarantine_retention_s=opt("gc_quarantine_retention_s"),
                   staging_retention_s=opt("gc_staging_retention_s"),
                   interval_s=opt("gc_interval_s") or 300.0)


def validate_gc_args(args: Dict[str, Any]) -> None:
    """Validate every ``gc``/``gc_*`` key, whether or not ``gc=true``:
    ``config.sanity_check`` calls it whenever one is present, so this
    command and a CLI run fail a typo alike (never a quota silently
    ignored)."""
    g = args.get("gc", False)
    if not isinstance(g, bool):
        raise ValueError(f"gc={g!r}: expected true or false (the storage "
                         "lifecycle plane, gc.py; docs/storage.md)")
    q = args.get("gc_quota_gb")
    if q is not None:
        try:
            qf = float(q)
        except (TypeError, ValueError):
            qf = -1.0
        if qf <= 0:
            raise ValueError(f"gc_quota_gb={q!r}: need a float > 0 in GB "
                             "(total accounted bytes before LRU eviction), "
                             "or null for accounting without a quota")
    for key in _RETENTION_KEYS:
        v = args.get(key)
        if v is None:
            continue
        try:
            vf = float(v)
        except (TypeError, ValueError):
            vf = -1.0
        if vf <= 0:
            raise ValueError(f"{key}={v!r}: need a float > 0 in seconds "
                             "(age before expiry), or null to keep that "
                             "plane account-only (docs/storage.md)")
    iv = args.get("gc_interval_s")
    if iv is not None and float(iv) <= 0:
        raise ValueError(f"gc_interval_s={iv!r}: need a float > 0 (the "
                         "--watch sweep cadence in seconds)")


# -- usage accounting ---------------------------------------------------------

def _tree_bytes(path: str) -> Tuple[int, int]:
    """(files, bytes) under ``path``; a missing directory counts zero."""
    n = b = 0
    for dirpath, _dirs, files in os.walk(path):
        for fn in files:
            try:
                b += os.path.getsize(os.path.join(dirpath, fn))
                n += 1
            except OSError:
                pass
    return n, b


def usage(root: str, *, cache_dir: Optional[str] = None,
          compile_dir: Optional[str] = None) -> Dict[str, Any]:
    """Bytes per plane and, where the gateway's admission journal records
    them, per tenant: stored upload bytes, accepted requests and the
    responses of those requests. ``root`` is the shared output root or
    spool; the cache and compile stores default to their process-wide
    locations (``cache.default_cache_dir``, ``compile_cache.default_root``).
    Needs no environment fingerprint: the monitor's heartbeat path runs
    this."""
    from .cache import default_cache_dir
    from .compile_cache import default_root as compile_default_root

    root = str(root)
    cache_dir = cache_dir or default_cache_dir()
    compile_dir = compile_dir or compile_default_root()
    planes: Dict[str, Dict[str, int]] = {}

    def plane(name: str, files: int, nbytes: int) -> None:
        planes[name] = {"files": int(files), "bytes": int(nbytes)}

    plane("cache", *_tree_bytes(cache_dir))
    plane("compile", *_tree_bytes(compile_dir))
    n = b = 0
    for sub in ("requests", "claimed", "done", "expired"):
        dn, db = _tree_bytes(os.path.join(root, sub))
        n, b = n + dn, b + db
    plane("spool", n, b)
    plane("inbox", *_tree_bytes(os.path.join(root, "inbox")))
    plane("incidents", *_tree_bytes(os.path.join(root, "_incidents")))
    plane("quarantine",
          *_tree_bytes(os.path.join(root, "_queue", "quarantined")))
    plane("staging", *_tree_bytes(os.path.join(root, "_queue", ".staging")))
    n = b = 0
    for pat in _JOURNAL_GLOBS:
        for p in Path(root).glob(pat):
            try:
                b += p.stat().st_size
                n += 1
            except OSError:
                pass
    plane("journals", n, b)

    # per tenant, off the admission journal: upload events carry
    # (tenant, sha256, bytes), accepted events (tenant, id); rid -> tenant
    # prices the spool's responses
    tenants: Dict[str, Dict[str, int]] = {}
    rid_tenant: Dict[str, str] = {}
    for jp in sorted(Path(root).glob("_gateway_*.jsonl")):
        for rec in read_jsonl(jp):
            t = rec.get("tenant")
            if not t:
                continue
            tt = tenants.setdefault(str(t), {"upload_bytes": 0,
                                             "accepted": 0,
                                             "spool_bytes": 0})
            ev = rec.get("event")
            if ev == "upload" and not rec.get("dedup"):
                tt["upload_bytes"] += int(rec.get("bytes") or 0)
            elif ev == "accepted":
                tt["accepted"] += 1
                rid_tenant[str(rec.get("id"))] = str(t)
    if rid_tenant:
        for sub in ("done", "expired"):
            d = os.path.join(root, sub)
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                t = rid_tenant.get(fn[:-len(".json")]) \
                    if fn.endswith(".json") else None
                if t is None:
                    continue
                try:
                    tenants[t]["spool_bytes"] += os.path.getsize(
                        os.path.join(d, fn))
                except OSError:
                    pass

    total = sum(p["bytes"] for p in planes.values())
    return {"root": root, "cache_dir": cache_dir,
            "compile_dir": compile_dir, "time": round(time.time(), 3),
            "planes": planes, "tenants": tenants, "total_bytes": total}


# -- eviction planning --------------------------------------------------------

class Deletion:
    """One planned delete: where, why, and how many bytes come back."""

    __slots__ = ("plane", "path", "bytes", "reason", "is_dir")

    def __init__(self, plane: str, path: str, nbytes: int, reason: str,
                 is_dir: bool = False) -> None:
        self.plane = plane
        self.path = str(path)
        self.bytes = int(nbytes)
        self.reason = str(reason)
        self.is_dir = bool(is_dir)

    def __repr__(self) -> str:
        return f"Deletion({self.plane}: {self.path} [{self.reason}])"


def _cache_entries(cache_dir: str) -> List[Tuple[float, int, str]]:
    """Every cache entry as ``(last_hit_mtime, bytes, path)``."""
    out = []
    for dirpath, _dirs, files in os.walk(cache_dir):
        for fn in files:
            if not fn.endswith(".pkl"):
                continue
            p = os.path.join(dirpath, fn)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, p))
    return out


def plan_cache(cache_dir: str, cfg: GcConfig, now: float,
               over_quota_bytes: int) -> List[Deletion]:
    """Last-hit LRU over the store: expire entries past retention, then
    evict coldest first until ``over_quota_bytes`` are recovered. Always
    safe: an evicted entry is a recoverable miss."""
    entries = sorted(_cache_entries(cache_dir))
    out: List[Deletion] = []
    recovered = 0
    for mtime, size, path in entries:
        age = now - mtime
        if cfg.cache_retention_s is not None and \
                age > cfg.cache_retention_s:
            out.append(Deletion("cache", path, size,
                                f"last hit {age:.0f}s ago > retention "
                                f"{cfg.cache_retention_s:.0f}s"))
            recovered += size
        elif recovered < over_quota_bytes:
            out.append(Deletion("cache", path, size,
                                f"LRU eviction under quota (last hit "
                                f"{age:.0f}s ago)"))
            recovered += size
    return out


def plan_compile(compile_dir: str, cfg: GcConfig, now: float
                 ) -> List[Deletion]:
    """Prune compile-store entries (``{family}/{key[:2]}/{key}/``) whose
    environment fingerprint is not this host's, once idle past retention.
    The fingerprint (``nvcc --version``, ``nvidia-smi``) is taken once per
    call, and only when the store holds an entry. Never planned: the entry
    this process attached and the directory ``kernels/build.py`` loads the
    library from (the default build directory is no store entry)."""
    from .compile_cache import MANIFEST_NAME, active, env_fingerprint
    from .kernels import build
    if cfg.compile_retention_s is None or not os.path.isdir(compile_dir):
        return []
    manifests = sorted(Path(compile_dir).glob(
        os.path.join("*", "*", "*", MANIFEST_NAME)))
    if not manifests:
        return []
    _env, env_fp = env_fingerprint()
    act = active()
    pinned_key = act.key if act is not None else None
    loading = os.path.realpath(str(build.library_dir()))
    out: List[Deletion] = []
    for man_path in manifests:
        entry_dir = man_path.parent
        try:
            man = json.loads(man_path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        if man.get("env_fp") == env_fp or entry_dir.name == pinned_key or \
                os.path.realpath(str(entry_dir)) == loading:
            continue
        try:
            age = now - entry_dir.stat().st_mtime
        except OSError:
            continue
        if age <= cfg.compile_retention_s:
            continue
        _n, b = _tree_bytes(str(entry_dir))
        out.append(Deletion(
            "compile", str(entry_dir), b,
            f"env_fp {str(man.get('env_fp'))[:12]} != active "
            f"{env_fp[:12]}, idle {age:.0f}s", is_dir=True))
    return out


def _claimable_rids(root: str) -> set:
    """rids with a live ``requests/`` or ``claimed/*/`` file: the spool's
    ground truth that a response deletion must never contradict."""
    rids = set()
    rq = os.path.join(root, "requests")
    if os.path.isdir(rq):
        for fn in os.listdir(rq):
            if fn.endswith(".json"):
                rids.add(fn[:-len(".json")])
    cl = os.path.join(root, "claimed")
    if os.path.isdir(cl):
        for host in os.listdir(cl):
            hd = os.path.join(cl, host)
            if not os.path.isdir(hd):
                continue
            for fn in os.listdir(hd):
                if fn.endswith(".json"):
                    rids.add(fn[:-len(".json")])
    return rids


def _referenced_inbox_blobs(root: str) -> set:
    """Inbox blob basenames that a live spool request (pending or claimed)
    names: never deletable while a request may still be served off
    them."""
    refs = set()
    dirs = [os.path.join(root, "requests")]
    cl = os.path.join(root, "claimed")
    if os.path.isdir(cl):
        dirs += [os.path.join(cl, h) for h in os.listdir(cl)]
    for d in dirs:
        if not os.path.isdir(d):
            continue
        for fn in os.listdir(d):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, fn), encoding="utf-8") as f:
                    req = json.load(f)
            except (OSError, ValueError):
                continue
            for v in req.get("video_paths") or []:
                refs.add(os.path.basename(str(v)))
    return refs


def plan_spool(root: str, cfg: GcConfig, now: float) -> List[Deletion]:
    """Expire terminal responses: ``done/`` and ``expired/`` files past
    retention whose request is no longer claimable."""
    if cfg.spool_retention_s is None:
        return []
    live = _claimable_rids(root)
    out: List[Deletion] = []
    for sub in ("done", "expired"):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".json"):
                continue
            rid = fn[:-len(".json")]
            p = os.path.join(d, fn)
            try:
                st = os.stat(p)
            except OSError:
                continue
            age = now - st.st_mtime
            if age <= cfg.spool_retention_s or rid in live:
                continue
            out.append(Deletion("spool", p, st.st_size,
                                f"{sub} response {age:.0f}s old, request "
                                "no longer claimable"))
    return out


def plan_inbox(root: str, cfg: GcConfig, now: float) -> List[Deletion]:
    """Expire upload blobs past retention that no live request names."""
    if cfg.inbox_retention_s is None:
        return []
    inbox = os.path.join(root, "inbox")
    if not os.path.isdir(inbox):
        return []
    refs = _referenced_inbox_blobs(root)
    out: List[Deletion] = []
    for fn in sorted(os.listdir(inbox)):
        p = os.path.join(inbox, fn)
        try:
            st = os.stat(p)
        except OSError:
            continue
        age = now - st.st_mtime
        if age <= cfg.inbox_retention_s or fn in refs:
            continue
        out.append(Deletion("inbox", p, st.st_size,
                            f"upload {age:.0f}s old, unreferenced"))
    return out


def plan_incidents(root: str, cfg: GcConfig, now: float) -> List[Deletion]:
    """Expire incident bundles past retention, except those an operator
    pinned (a ``pinned`` file in the bundle)."""
    if cfg.incident_retention_s is None:
        return []
    inc = os.path.join(root, "_incidents")
    if not os.path.isdir(inc):
        return []
    out: List[Deletion] = []
    for name in sorted(os.listdir(inc)):
        bundle = os.path.join(inc, name)
        if not os.path.isdir(bundle):
            continue
        if os.path.exists(os.path.join(bundle, "pinned")):
            continue
        try:
            age = now - os.stat(bundle).st_mtime
        except OSError:
            continue
        if age <= cfg.incident_retention_s:
            continue
        _n, b = _tree_bytes(bundle)
        out.append(Deletion("incidents", bundle, b,
                            f"bundle {age:.0f}s old, not pinned",
                            is_dir=True))
    return out


def plan_quarantine(root: str, cfg: GcConfig, now: float) -> List[Deletion]:
    """Expire quarantined queue items past retention: the POISON journal
    record is the durable evidence; the marker only blocks re-seeding,
    which expiry allows again on purpose."""
    if cfg.quarantine_retention_s is None:
        return []
    q = os.path.join(root, "_queue", "quarantined")
    if not os.path.isdir(q):
        return []
    out: List[Deletion] = []
    for fn in sorted(os.listdir(q)):
        if not fn.endswith(".json"):
            continue
        p = os.path.join(q, fn)
        try:
            st = os.stat(p)
        except OSError:
            continue
        age = now - st.st_mtime
        if age <= cfg.quarantine_retention_s:
            continue
        out.append(Deletion("quarantine", p, st.st_size,
                            f"quarantined {age:.0f}s ago"))
    return out


def plan_staging(root: str, cfg: GcConfig, now: float) -> List[Deletion]:
    """Delete ``.staging/`` remnants whose item already has a done marker
    (completed work abandoned mid-steal). A remnant without one is never
    planned: the queue's own sweep (``parallel/queue.py``,
    ``staging_retention_s``) recovers it to pending."""
    if cfg.staging_retention_s is None:
        return []
    st_dir = os.path.join(root, "_queue", ".staging")
    done_dir = os.path.join(root, "_queue", "done")
    if not os.path.isdir(st_dir):
        return []
    out: List[Deletion] = []
    for fn in sorted(os.listdir(st_dir)):
        if not fn.endswith(".json"):
            continue
        p = os.path.join(st_dir, fn)
        try:
            with open(p, encoding="utf-8") as f:
                iid = str(json.load(f).get("id"))
        except (OSError, ValueError):
            continue
        if not os.path.exists(os.path.join(done_dir, f"{iid}.json")):
            continue
        try:
            st = os.stat(p)
        except OSError:
            continue
        age = now - st.st_mtime
        if age <= cfg.staging_retention_s:
            continue
        out.append(Deletion("staging", p, st.st_size,
                            f"staged remnant of done item {iid}, "
                            f"{age:.0f}s old"))
    return out


def plan(root: str, cfg: GcConfig, *, cache_dir: Optional[str] = None,
         compile_dir: Optional[str] = None,
         now: Optional[float] = None,
         use: Optional[Dict[str, Any]] = None) -> List[Deletion]:
    """The sweep's plan over every plane. Quota pressure is resolved
    against the recoverable plane only (cache LRU): a byte target never
    overrides the retention planes' correctness rules."""
    now = time.time() if now is None else float(now)
    use = use or usage(root, cache_dir=cache_dir, compile_dir=compile_dir)
    cache_dir = use["cache_dir"]
    compile_dir = use["compile_dir"]
    over = 0
    if cfg.quota_bytes is not None and \
            use["total_bytes"] > cfg.quota_bytes:
        over = use["total_bytes"] - cfg.quota_bytes
    deletions: List[Deletion] = []
    deletions += plan_cache(cache_dir, cfg, now, over)
    deletions += plan_compile(compile_dir, cfg, now)
    deletions += plan_spool(root, cfg, now)
    deletions += plan_inbox(root, cfg, now)
    deletions += plan_incidents(root, cfg, now)
    deletions += plan_quarantine(root, cfg, now)
    deletions += plan_staging(root, cfg, now)
    return deletions


# -- journaled execution ------------------------------------------------------

def _journal_record(d: Deletion, root: str, host_id: str) -> dict:
    try:
        rel = os.path.relpath(d.path, root)
    except ValueError:
        rel = d.path
    return {"schema": GC_JOURNAL_SCHEMA, "event": "evict",
            "time": round(time.time(), 3), "host_id": host_id,
            "plane": d.plane, "path": d.path, "rel": rel,
            "bytes": d.bytes, "reason": d.reason}


def execute(root: str, deletions: List[Deletion],
            host_id: Optional[str] = None) -> Dict[str, Any]:
    """Run the plan: append each delete to ``_gc_{host}.jsonl``, then
    unlink. Dying in between (``gc.evict`` ``drop``/``kill``) is
    recoverable: the journaled path still satisfies its planner, so the
    next run journals and completes it. Returns per-plane tallies."""
    from .telemetry import inc
    from .utils import inject

    host_id = host_id or f"{socket.gethostname()}-{os.getpid()}"
    jpath = os.path.join(str(root), journal_filename(host_id))
    tally = {p: {"deleted": 0, "bytes": 0, "errors": 0} for p in PLANES}
    for d in deletions:
        append_jsonl(jpath, _journal_record(d, str(root), host_id))
        try:
            fault = inject.fire("gc.evict", plane=d.plane,
                                path=os.path.basename(d.path))
            if fault is not None and fault.kind == "drop":
                # the crash window: journaled, never unlinked, as a
                # SIGKILL between the two lines leaves it
                continue
            if d.is_dir:
                shutil.rmtree(d.path, ignore_errors=False)
            else:
                os.unlink(d.path)
        except FileNotFoundError:
            pass  # a sibling sweep or the owner got there first
        except OSError as e:
            # a failed unlink (or an injected eio/enospc) is a
            # journaled-but-present remnant: counted, named, and planned
            # again by the next run, never a crashed sweep
            tally[d.plane]["errors"] += 1
            inc("vft_gc_sweep_errors_total", plane=d.plane)
            print(f"gc: cannot delete {d.path}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            continue
        tally[d.plane]["deleted"] += 1
        tally[d.plane]["bytes"] += d.bytes
        inc("vft_gc_evicted_total", plane=d.plane)
        inc("vft_gc_evicted_bytes_total", d.bytes, plane=d.plane)
    return {p: t for p, t in tally.items()
            if t["deleted"] or t["errors"]}


def sweep(root: str, cfg: GcConfig, *, cache_dir: Optional[str] = None,
          compile_dir: Optional[str] = None,
          host_id: Optional[str] = None,
          dry_run: bool = False) -> Dict[str, Any]:
    """One accounting and eviction pass: what the command runs once, and
    ``--watch`` on a cadence (inject site ``gc.sweep``)."""
    from .telemetry import inc
    from .utils import inject

    fault = inject.fire("gc.sweep", root=str(root))
    if fault is not None and fault.kind == "stall":
        time.sleep(0.25)  # a slow disk mid-sweep; the plan stays valid
    use = usage(root, cache_dir=cache_dir, compile_dir=compile_dir)
    deletions = plan(root, cfg, cache_dir=cache_dir,
                     compile_dir=compile_dir, use=use)
    planned_bytes = sum(d.bytes for d in deletions)
    executed: Dict[str, Any] = {}
    if deletions and not dry_run:
        executed = execute(root, deletions, host_id=host_id)
    inc("vft_gc_sweeps_total")
    inc("vft_gc_retained_total",
        sum(p["files"] for p in use["planes"].values())
        - sum(t["deleted"] for t in executed.values()))
    return {"usage": use, "planned": len(deletions),
            "planned_bytes": planned_bytes, "executed": executed,
            "dry_run": bool(dry_run),
            "quota_bytes": cfg.quota_bytes}


# -- heartbeat / metrics publication ------------------------------------------

class GcMonitor:
    """The accounting half on a run's heartbeat: registers the ``gc``
    section on a recorder and refreshes the usage walk at most once per
    ``cfg.interval_s``; between refreshes the section republishes the
    cached numbers, so a heartbeat never pays a tree walk."""

    def __init__(self, root: str, cfg: GcConfig, *,
                 cache_dir: Optional[str] = None,
                 compile_dir: Optional[str] = None,
                 clock=time.time) -> None:
        self.root = str(root)
        self.cfg = cfg
        self.cache_dir = cache_dir
        self.compile_dir = compile_dir
        self.clock = clock
        self._last: Optional[Dict[str, Any]] = None
        self._last_t = 0.0
        self._recorder = None

    def snapshot(self) -> Dict[str, Any]:
        now = self.clock()
        if self._last is None or now - self._last_t >= self.cfg.interval_s:
            self._last = usage(self.root, cache_dir=self.cache_dir,
                               compile_dir=self.compile_dir)
            self._last_t = now
            self._publish(self._last)
        return self._last

    def _publish(self, use: Dict[str, Any]) -> None:
        r = self._recorder
        if r is None:
            return
        r.registry.gauge("vft_gc_used_bytes").set(use["total_bytes"])
        if self.cfg.quota_bytes is not None:
            r.registry.gauge("vft_gc_quota_bytes").set(self.cfg.quota_bytes)
        for plane_name, p in use["planes"].items():
            r.registry.gauge("vft_gc_plane_bytes",
                             plane=plane_name).set(p["bytes"])
        for tenant, t in use["tenants"].items():
            r.registry.gauge("vft_gc_tenant_bytes", tenant=tenant).set(
                t["upload_bytes"] + t["spool_bytes"])

    def section(self) -> Dict[str, Any]:
        use = self.snapshot()
        out: Dict[str, Any] = {
            "used_bytes": use["total_bytes"],
            "quota_bytes": self.cfg.quota_bytes,
            "planes": {p: v["bytes"] for p, v in use["planes"].items()},
        }
        if use["tenants"]:
            out["tenants"] = {
                t: v["upload_bytes"] + v["spool_bytes"]
                for t, v in use["tenants"].items()}
        return out

    def attach(self, recorder) -> "GcMonitor":
        self._recorder = recorder
        recorder.extra_sections["gc"] = self.section
        return self


# -- CLI ----------------------------------------------------------------------

def _fmt_bytes(b: Optional[int]) -> str:
    if b is None:
        return "-"
    v = float(b)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if v < 1000 or unit == "TB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1000.0
    return f"{v:.1f}TB"


def render_report(result: Dict[str, Any]) -> List[str]:
    use = result["usage"]
    quota = result.get("quota_bytes")
    lines = [f"gc: {use['root']}",
             f"== usage ==  total={_fmt_bytes(use['total_bytes'])}"
             + (f"  quota={_fmt_bytes(quota)}" if quota else "")]
    for plane_name in PLANES:
        p = use["planes"].get(plane_name) or {}
        if not p.get("files"):
            continue
        lines.append(f"  {plane_name:<11} {p['files']:>6} file(s)  "
                     f"{_fmt_bytes(p['bytes'])}")
    for t, v in sorted((use.get("tenants") or {}).items()):
        lines.append(f"  tenant {t:<10} uploads="
                     f"{_fmt_bytes(v['upload_bytes'])}  responses="
                     f"{_fmt_bytes(v['spool_bytes'])}  "
                     f"accepted={v['accepted']}")
    verb = "planned (dry run)" if result["dry_run"] else "planned"
    lines.append(f"== sweep ==  {result['planned']} deletion(s) {verb}, "
                 f"{_fmt_bytes(result['planned_bytes'])}")
    for plane_name, t in sorted((result.get("executed") or {}).items()):
        lines.append(f"  {plane_name:<11} deleted={t['deleted']}  "
                     f"{_fmt_bytes(t['bytes'])}"
                     + (f"  errors={t['errors']}" if t["errors"] else ""))
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch gc",
        description="storage lifecycle plane: account + journaled "
                    "eviction over the fleet's durable artifacts")
    ap.add_argument("root", help="the shared out_root / spool dir")
    ap.add_argument("--cache-dir", default=None,
                    help="feature-cache store (default VFT_CACHE_DIR)")
    ap.add_argument("--compile-dir", default=None,
                    help="compile store (default VFT_COMPILE_CACHE_DIR)")
    ap.add_argument("--quota-gb", type=float, default=None,
                    help="total byte quota; excess is LRU-evicted from "
                         "the recoverable planes (= gc_quota_gb)")
    for key in _RETENTION_KEYS:
        flag = "--" + key[len("gc_"):].replace("_", "-")
        ap.add_argument(flag, type=float, default=None, dest=key,
                        help=f"= {key} (seconds; unset = account-only)")
    ap.add_argument("--watch", action="store_true",
                    help="sweep on a cadence until interrupted")
    ap.add_argument("--every", type=float, default=None,
                    help="--watch cadence in seconds (= gc_interval_s, "
                         "default 300)")
    ap.add_argument("--iterations", type=int, default=0,
                    help="--watch passes before exiting (0 = forever)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan, delete nothing")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable result on stdout")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"error: {args.root} is not a directory", file=sys.stderr)
        return 2
    # the config keys and the flags validate alike
    cfg_args: Dict[str, Any] = {"gc": True}
    if args.quota_gb is not None:
        cfg_args["gc_quota_gb"] = args.quota_gb
    for key in _RETENTION_KEYS:
        if getattr(args, key) is not None:
            cfg_args[key] = getattr(args, key)
    if args.every is not None:
        cfg_args["gc_interval_s"] = args.every
    validate_gc_args(cfg_args)
    cfg = GcConfig.from_args(cfg_args)
    passes = 0
    while True:
        result = sweep(args.root, cfg, cache_dir=args.cache_dir,
                       compile_dir=args.compile_dir, dry_run=args.dry_run)
        if args.json:
            print(json.dumps(result, sort_keys=True))
        else:
            print("\n".join(render_report(result)))
        passes += 1
        if not args.watch or (args.iterations
                              and passes >= args.iterations):
            break
        try:
            time.sleep(max(0.05, cfg.interval_s))
        except KeyboardInterrupt:
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
