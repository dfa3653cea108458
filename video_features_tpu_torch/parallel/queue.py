"""Work-stealing fleet queue: filesystem-coordinated dynamic work claims
(port of ``video_features_tpu/parallel/queue.py``).

Static hash sharding (:func:`~.mesh.local_shard_of_list`) fixes every
video's owner at launch, so fleet makespan is the slowest shard: one long
video, one throttled host or one preempted worker idles every other card
while it finishes, and membership cannot change mid-run. This module
replaces that with a dynamic queue coordinated through the shared output
filesystem alone (no daemon, no coordinator): makespan approaches
``total_work / n_hosts`` instead of ``max(shard)``.

Layout, under the run's shared output root (the JAX package's, so either
package's hosts may drain one queue)::

    {out_root}/_queue/
      pending/{item_id}.json            un-owned work items
      claimed/{host_id}/{item_id}.json  leased items (lease stamp inside)
      done/{item_id}.json               completion records (first writer wins)
      quarantined/{item_id}.json        pathological items (>= max_reclaims)
      .staging/                         reclaim-in-progress scratch
      canary/{host_id}/                 joining-host canary slice + verdict

**Claim**: ``os.rename(pending/x, claimed/{me}/x)``, atomic on POSIX; a
losing racer sees ENOENT. The claimant then stamps a lease ``{host_id,
run_id, claim_time, deadline, reclaims}`` by atomic replace.

**Leases** are renewed from the telemetry heartbeat thread
(:meth:`WorkQueue.heartbeat_section` is a ``recorder.extra_sections``
hook): a live host's leases never expire, a dead or stalled host's expire
within one lease period.

**Stealing**: an idle host (:meth:`WorkQueue.reclaim_expired`) moves claims
whose lease passed, or whose owner's heartbeat is stale or final, back to
``pending/`` with ``reclaims`` bumped (through a staging rename, so two
stealers cannot both requeue), and claims them like any other item. An item
reclaimed more than ``max_reclaims`` times is quarantined through the
failure journal (``utils/faults.py``) instead of dispatched forever.

**Membership** is discovered: any process that seeds the same list into the
same root takes part; hosts may join or leave mid-run. A joining host can be
gated by the **canary** (:meth:`WorkQueue.canary_gate`): it re-extracts a
slice of completed work and must pass the digest bands of
``compare_runs.py`` and the timing band of ``scripts/bench_history.py`` (the
port's own copy below) before it claims.

**Exactly once**: a video is always in at least one of pending, claimed or
done; completion writes the ``done/`` marker with ``O_EXCL`` (first writer
wins) before the claim is released; claimants discard a claim whose done
marker exists; and the sinks' skip-if-exists and atomic writes are the last
backstop, so a duplicate dispatch never becomes a duplicate or torn output.

``fleet=static`` (the default) bypasses all of this.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
import uuid
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .. import telemetry
from ..compare_runs import compare_digests, load_health
from ..telemetry import trace
from ..telemetry.heartbeat import STALL_INTERVALS, heartbeat_filename
from ..telemetry.jsonl import append_jsonl, read_jsonl, write_json_atomic
from ..utils import inject

QUEUE_DIRNAME = "_queue"
PENDING, CLAIMED, DONE, QUARANTINED = ("pending", "claimed", "done",
                                       "quarantined")
STAGING = ".staging"
ITEM_SCHEMA = "vft.fleet_item/1"
DONE_SCHEMA = "vft.fleet_done/1"

#: orphaned staging files (a stealer died mid-reclaim) older than this
#: many lease periods are recovered back into pending/
STAGING_ORPHAN_LEASES = 4.0

#: canary timing band for a compile-warm joining host: the generous
#: default band absorbs a cold host's kernel build, so a host whose
#: compile-cache entry was warm at attach (compile_cache.py) is held to
#: this tighter bar instead: it has no build to pay
WARM_CANARY_BAND = 0.25

#: the timing history's record schema (scripts/bench_history.py)
HISTORY_SCHEMA = "vft.bench_history/1"


def _safe(name: str) -> str:
    """Filesystem-safe id (host ids embed hostnames, stems embed user
    filenames) — same sanitation as telemetry/heartbeat.py."""
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(name))


def item_id(video: str) -> str:
    """Stable, collision-free, filesystem-safe id for one work item:
    readable stem prefix + a hash of the full path (stems are unique
    within a run — sanity_check — but the hash keeps ids safe across
    runs that reuse the queue root with different directories)."""
    stem = _safe(Path(str(video)).stem)[:80]
    h = hashlib.md5(str(video).encode()).hexdigest()[:10]
    return f"{stem}-{h}"


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


class WorkQueue:
    """One host's handle on the shared fleet queue.

    ``clock`` is injectable so tests exercise lease expiry without
    sleeping; everything else is plain filesystem state, so N instances
    (threads, processes, or hosts on a shared mount) coordinate with no
    other channel.
    """

    def __init__(self, out_root: str, *, host_id: str,
                 run_id: Optional[str] = None,
                 lease_s: float = 60.0, max_reclaims: int = 3,
                 journal=None,
                 staging_retention_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time) -> None:
        if float(lease_s) <= 0:
            raise ValueError(f"fleet_lease_s={lease_s}: need > 0")
        if int(max_reclaims) < 1:
            raise ValueError(f"fleet_max_reclaims={max_reclaims}: need >= 1")
        if staging_retention_s is not None and float(staging_retention_s) <= 0:
            raise ValueError(
                f"gc_staging_retention_s={staging_retention_s}: need > 0")
        self.out_root = str(out_root)
        self.root = os.path.join(self.out_root, QUEUE_DIRNAME)
        self.host_id = str(host_id)
        self.run_id = run_id
        self.lease_s = float(lease_s)
        self.max_reclaims = int(max_reclaims)
        # how long a .staging/ orphan may sit before recovery sweeps it
        # back to pending: the GC retention knob when set (gc.py), else
        # the legacy several-lease heuristic
        self.staging_retention_s = (
            float(staging_retention_s) if staging_retention_s is not None
            else STAGING_ORPHAN_LEASES * self.lease_s)
        self.journal = journal
        self.clock = clock
        self.host_dir = os.path.join(self.root, CLAIMED, _safe(self.host_id))
        for d in (PENDING, DONE, QUARANTINED, STAGING):
            os.makedirs(os.path.join(self.root, d), exist_ok=True)
        os.makedirs(self.host_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._active: Dict[str, dict] = {}  # item_id -> claim record
        self._tallies = {"claimed": 0, "stolen": 0, "reclaimed": 0,
                         "requeued": 0, "done": 0, "quarantined": 0,
                         "lease_lost": 0, "duplicate_discarded": 0}
        self._canary_state = "off"
        #: set by the CLI when this host's compile-cache entry was
        #: warm at attach (compile_cache.py): the canary gate drops its
        #: cold-build timing allowance, and the heartbeat fleet section
        #: records it for the fleet report
        self.canary_warm = False
        #: cumulative seconds this host spent idle-waiting on other
        #: hosts' live leases (the drain loop's fleet.idle_wait spans,
        #: summed) — the stall-share input to the capacity planner
        #: (fleet_report.py CapacityPlanner)
        self._idle_wait_s = 0.0

    # -- path helpers -------------------------------------------------------
    def _p(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def _done_path(self, iid: str) -> str:
        return self._p(DONE, f"{iid}.json")

    def _claim_path(self, iid: str) -> str:
        return os.path.join(self.host_dir, f"{iid}.json")

    # -- seeding ------------------------------------------------------------
    def seed(self, videos: List[str]) -> int:
        """Idempotently publish the work list: every video not already
        pending/claimed/done/quarantined gets a ``pending/`` item
        (``O_EXCL``, so concurrent seeders never duplicate). Every host
        seeds the same list at startup — a late joiner recovers items a
        reclaimer lost mid-move, and already-finished work stays
        finished (claimants re-check the done marker, see claim_next)."""
        added = 0
        for video in videos:
            iid = item_id(video)
            if os.path.exists(self._done_path(iid)) or \
                    os.path.exists(self._p(QUARANTINED, f"{iid}.json")) or \
                    self._claimed_anywhere(iid):
                continue
            rec = {"schema": ITEM_SCHEMA, "id": iid, "video": str(video),
                   "reclaims": 0, "seeded_by": self.host_id,
                   "time": round(self.clock(), 3)}
            try:
                # O_EXCL create, not rename-into-place: a rename would
                # clobber a concurrent seeder's (or requeuer's) item
                fd = os.open(self._p(PENDING, f"{iid}.json"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                # vft-lint: disable=VFT004 — O_EXCL create IS the atomicity: a rename would clobber a concurrent seeder; a torn record is healed by the idempotent re-seed
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(rec, f)
                added += 1
            except FileExistsError:
                pass
        return added

    def _claimed_anywhere(self, iid: str) -> bool:
        claimed_root = self._p(CLAIMED)
        try:
            hosts = os.listdir(claimed_root)
        except OSError:
            return False
        return any(os.path.exists(os.path.join(claimed_root, h,
                                               f"{iid}.json"))
                   for h in hosts)

    # -- claiming -----------------------------------------------------------
    def claim_next(self) -> Optional[dict]:
        """Claim the first pending item (name order, so seed order — the
        operator can front-load known-long videos). Returns the stamped
        claim record, or None when nothing is claimable."""
        try:
            names = sorted(n for n in os.listdir(self._p(PENDING))
                           if n.endswith(".json"))
        except OSError:
            return None
        for name in names:
            src = self._p(PENDING, name)
            dst = os.path.join(self.host_dir, name)
            with trace.span("fleet.claim", item=name[:-len(".json")]):
                try:
                    # chaos hooks (utils/inject.py): `queue.claim=eio`
                    # fails the rename like a lost race; `skew` stamps an
                    # already-expired lease (a claimant whose clock — or
                    # whose renewals — lag the fleet's), making the claim
                    # immediately stealable while this host still works it
                    fault = inject.fire("queue.claim",
                                        item=name[:-len(".json")])
                    os.rename(src, dst)
                except OSError:
                    continue  # another host won this item; try the next
                rec = _read_json(dst) or {"id": name[:-len(".json")],
                                          "video": None, "reclaims": 0}
                iid = str(rec.get("id") or name[:-len(".json")])
                if os.path.exists(self._done_path(iid)):
                    # re-seed race lost to a completed item: the done
                    # marker is ground truth — discard, never re-extract
                    try:
                        os.unlink(dst)
                    except OSError:
                        pass
                    with self._lock:
                        self._tallies["duplicate_discarded"] += 1
                    continue
                stolen = int(rec.get("reclaims", 0)) > 0 and \
                    rec.get("last_owner") not in (None, self.host_id)
                now = self.clock()
                deadline = now + self.lease_s
                if fault is not None and fault.kind == "skew":
                    deadline = now - self.lease_s  # already expired
                rec.update(host_id=self.host_id, run_id=self.run_id,
                           claim_time=round(now, 3),
                           deadline=round(deadline, 3))
                # request correlation (telemetry/context.py): a lease
                # claimed on behalf of a spool request carries its id, so
                # the claim/steal/quarantine trail of a request's videos
                # is retrievable too; absent outside serve mode
                rid = telemetry.current_request_id()
                if rid is not None:
                    rec["request_id"] = rid
                write_json_atomic(dst, rec)
            with self._lock:
                self._active[iid] = rec
                self._tallies["claimed"] += 1
                if stolen:
                    self._tallies["stolen"] += 1
            telemetry.inc("vft_fleet_claimed_total")
            if stolen:
                telemetry.inc("vft_fleet_stolen_total")
                trace.instant("fleet.steal", item=iid,
                              prev_owner=str(rec.get("last_owner")),
                              reclaims=int(rec.get("reclaims", 0)))
            return rec
        return None

    # -- lease maintenance --------------------------------------------------
    def renew_leases(self) -> None:
        """Push this host's active lease deadlines forward. Called from
        the heartbeat flusher thread (via :meth:`heartbeat_section`) —
        a live host's leases therefore never expire, and a dead/stalled
        host's expire within one lease period."""
        with self._lock:
            active = dict(self._active)
        now = self.clock()
        for iid, rec in active.items():
            path = self._claim_path(iid)
            if not os.path.exists(path):
                # stolen from under us (we stalled past the lease and
                # somebody reclaimed): drop it — complete() re-checks too
                with self._lock:
                    if self._active.pop(iid, None) is not None:
                        self._tallies["lease_lost"] += 1
                continue
            rec = dict(rec, deadline=round(now + self.lease_s, 3))
            write_json_atomic(path, rec)
            with self._lock:
                if iid in self._active:
                    self._active[iid] = rec

    def _owner_stale(self, host_dirname: str,
                     hb_cache: Dict[str, Optional[dict]]) -> bool:
        """True when a claim-dir owner's heartbeat says it cannot renew:
        missing (never started telemetry — impossible for a live queue
        participant), marked final, or silent past the stall window."""
        if host_dirname not in hb_cache:
            hb_cache[host_dirname] = _read_json(
                os.path.join(self.out_root, heartbeat_filename(host_dirname)))
        hb = hb_cache[host_dirname]
        if hb is None:
            return True
        if hb.get("final"):
            return True
        interval = float(hb.get("interval_s", 30.0) or 30.0)
        age = self.clock() - float(hb.get("time", 0))
        return age > STALL_INTERVALS * interval

    def reclaim_expired(self) -> int:
        """Steal back expired leases: every claim whose deadline passed,
        or whose owner's heartbeat is stale/final, goes back to
        ``pending/`` with ``reclaims`` bumped — unless it has been
        reclaimed ``max_reclaims`` times already, in which case it is
        quarantined as pathological. Returns the number of items made
        claimable again."""
        requeued = 0
        hb_cache: Dict[str, Optional[dict]] = {}
        claimed_root = self._p(CLAIMED)
        try:
            hosts = [h for h in os.listdir(claimed_root)
                     if h != _safe(self.host_id)]
        except OSError:
            hosts = []
        now = self.clock()
        for host in hosts:
            hdir = os.path.join(claimed_root, host)
            try:
                names = [n for n in os.listdir(hdir) if n.endswith(".json")]
            except OSError:
                continue
            for name in names:
                path = os.path.join(hdir, name)
                rec = _read_json(path)
                if rec is None:
                    continue  # mid-stamp or torn; next scan decides
                deadline = rec.get("deadline")
                expired = deadline is not None and float(deadline) < now
                if not expired and not self._owner_stale(host, hb_cache):
                    continue
                if self._requeue(path, rec, reason="lease expired"
                                 if expired else "owner heartbeat stale"):
                    requeued += 1
        requeued += self._sweep_staging(now)
        return requeued

    def _requeue(self, claimed_path: str, rec: dict, *,
                 reason: str, bump: bool = True) -> bool:
        """Atomically move one claim back to pending (or quarantine).
        The staging rename is the mutual exclusion: exactly one stealer
        wins the source file."""
        iid = str(rec.get("id") or Path(claimed_path).stem)
        staging = self._p(STAGING, f"{uuid.uuid4().hex[:8]}.{iid}.json")
        try:
            os.rename(claimed_path, staging)
        except OSError:
            return False  # another stealer (or the owner's unlink) won
        # chaos hook: the stealer "dies" exactly between the two renames
        # (`drop` abandons the item in .staging/, which ONLY the orphan
        # sweep can recover; `kill` is the real SIGKILL for subprocess
        # chaos runs) — the narrowest window in the steal protocol
        fault = inject.fire("queue.steal_staging", item=iid)
        if fault is not None and fault.kind == "drop":
            return False
        prev_owner = rec.get("host_id")
        reclaims = int(rec.get("reclaims", 0)) + (1 if bump else 0)
        rec = {"schema": ITEM_SCHEMA, "id": iid, "video": rec.get("video"),
               "reclaims": reclaims, "last_owner": prev_owner,
               "seeded_by": rec.get("seeded_by"),
               "time": round(self.clock(), 3)}
        if bump:
            with self._lock:
                self._tallies["reclaimed"] += 1
            telemetry.inc("vft_fleet_reclaimed_total")
            trace.instant("fleet.reclaim", item=iid,
                          prev_owner=str(prev_owner), reason=reason,
                          reclaims=reclaims)
        if bump and reclaims > self.max_reclaims:
            self._quarantine(rec, staging)
            return False  # off the queue, not claimable
        write_json_atomic(self._p(PENDING, f"{iid}.json"), rec)
        with self._lock:
            self._tallies["requeued"] += 1
        telemetry.inc("vft_fleet_requeued_total")
        try:
            os.unlink(staging)
        except OSError:
            pass
        return True

    def _quarantine(self, rec: dict, staging: str) -> None:
        """Route a pathological item (reclaimed past the cap — it has
        repeatedly outlived or taken down its claimants) through the
        existing quarantine machinery: a queue-level marker plus a
        POISON record in the failure journal, so restarted workers and
        ``retry_failed=true`` follow the journal's contract unchanged."""
        iid = str(rec.get("id"))
        write_json_atomic(self._p(QUARANTINED, f"{iid}.json"), rec)
        with self._lock:
            self._tallies["quarantined"] += 1
        telemetry.inc("vft_fleet_quarantined_total")
        trace.instant("fleet.quarantine", item=iid,
                      reclaims=int(rec.get("reclaims", 0)))
        if self.journal is not None and rec.get("video"):
            try:
                from ..utils.faults import POISON
                self.journal.record(
                    rec["video"], POISON, attempts=int(rec["reclaims"]),
                    error=f"fleet: lease reclaimed {rec['reclaims']}x "
                          f"(> fleet_max_reclaims={self.max_reclaims}); "
                          "item repeatedly killed or outlived its workers",
                    elapsed_s=0.0)
            except Exception:
                pass  # the quarantine marker alone still blocks re-dispatch
        try:
            os.unlink(staging)
        except OSError:
            pass

    def _sweep_staging(self, now: float) -> int:
        """Recover items a stealer lost mid-reclaim (died between the
        staging rename and the pending write): anything in .staging/
        older than ``staging_retention_s`` (the GC retention knob, or a
        several-lease default) goes back to pending unless its done
        marker exists."""
        recovered = 0
        try:
            names = [n for n in os.listdir(self._p(STAGING))
                     if n.endswith(".json")]
        except OSError:
            return 0
        for name in names:
            path = self._p(STAGING, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age < self.staging_retention_s:
                continue
            rec = _read_json(path)
            if rec is None or not rec.get("id"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if os.path.exists(self._done_path(str(rec["id"]))):
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if self._requeue(path, rec, reason="staging orphan",
                             bump=False):
                recovered += 1
        return recovered

    # -- completion / release -----------------------------------------------
    def complete(self, rec: dict, status: str, *,
                 elapsed_s: Optional[float] = None,
                 families: Optional[Dict[str, str]] = None) -> bool:
        """Publish one item's completion. First writer wins (``O_EXCL``):
        if another host finished a stolen copy first, this host's result
        is identical anyway (idempotent sinks) and only the marker race
        is lost. Returns True when this host's record became the
        marker."""
        iid = str(rec.get("id"))
        done = {"schema": DONE_SCHEMA, "id": iid,
                "video": rec.get("video"), "status": str(status),
                "by": self.host_id, "run_id": self.run_id,
                "reclaims": int(rec.get("reclaims", 0)),
                "time": round(self.clock(), 3)}
        if elapsed_s is not None:
            done["elapsed_s"] = round(float(elapsed_s), 3)
        if families:
            done["families"] = dict(families)
        won = True
        try:
            fd = os.open(self._done_path(iid),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            # vft-lint: disable=VFT004 — done markers are O_EXCL first-writer-wins (exactly-once contract); the audit tolerates a torn marker body, existence is the signal
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(done, f)
        except FileExistsError:
            won = False
        with self._lock:
            self._active.pop(iid, None)
            self._tallies["done" if won else "lease_lost"] += 1
        try:
            os.unlink(self._claim_path(iid))
        except OSError:
            pass
        return won

    def release(self, rec: dict) -> None:
        """Voluntarily hand a claim back (SIGTERM drain, escaped caller
        exception): the item returns to pending WITHOUT a reclaim bump —
        a graceful exit is not a pathology signal."""
        iid = str(rec.get("id"))
        with self._lock:
            self._active.pop(iid, None)
        path = self._claim_path(iid)
        if os.path.exists(path):
            self._requeue(path, rec, reason="released", bump=False)

    def release_all(self) -> int:
        with self._lock:
            active = list(self._active.values())
        for rec in active:
            self.release(rec)
        return len(active)

    # -- state --------------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in (PENDING, DONE, QUARANTINED):
            try:
                out[d] = sum(1 for n in os.listdir(self._p(d))
                             if n.endswith(".json"))
            except OSError:
                out[d] = 0
        claimed = 0
        try:
            for h in os.listdir(self._p(CLAIMED)):
                try:
                    claimed += sum(
                        1 for n in os.listdir(self._p(CLAIMED, h))
                        if n.endswith(".json"))
                except OSError:
                    pass
        except OSError:
            pass
        out[CLAIMED] = claimed
        return out

    def all_done(self) -> bool:
        c = self.counts()
        return c[PENDING] == 0 and c[CLAIMED] == 0

    def live_hosts(self) -> List[str]:
        """Queue membership right now: host_ids with a fresh, non-final
        heartbeat in the output root (joiners appear, leavers age out —
        nothing is fixed at launch)."""
        import glob as _glob
        out = []
        now = self.clock()
        for p in _glob.glob(os.path.join(self.out_root,
                                         "_heartbeat_*.json")):
            hb = _read_json(p)
            if hb is None or hb.get("final"):
                continue
            interval = float(hb.get("interval_s", 30.0) or 30.0)
            if now - float(hb.get("time", 0)) <= STALL_INTERVALS * interval:
                out.append(str(hb.get("host_id")))
        return sorted(out)

    def heartbeat_section(self) -> dict:
        """The ``fleet`` heartbeat section AND the lease-renewal tick:
        installed as a ``recorder.extra_sections`` hook so the existing
        heartbeat flusher thread keeps this host's claims alive and
        publishes fleet state in one atomic heartbeat write."""
        self.renew_leases()
        with self._lock:
            tallies = dict(self._tallies)
            active = dict(self._active)
        now = self.clock()
        oldest = max((now - float(r.get("claim_time", now))
                      for r in active.values()), default=0.0)
        with self._lock:
            idle_s = self._idle_wait_s
        return {"mode": "queue", "lease_s": self.lease_s,
                "host_id": self.host_id,
                "active_claims": len(active),
                "oldest_active_claim_age_s": round(oldest, 3),
                "queue": self.counts(), "canary": self._canary_state,
                "canary_warm": bool(self.canary_warm),
                "idle_wait_s_total": round(idle_s, 3),
                **tallies}

    # -- the drain loop ------------------------------------------------------
    def drain(self, run_fn: Callable[[str], str], *, workers: int = 1,
              stop: Optional[threading.Event] = None, poll_s: float = 0.5,
              on_complete: Optional[Callable[[dict, str], None]] = None
              ) -> None:
        """Claim -> extract -> complete until the queue is drained
        fleet-wide. ``run_fn(video) -> status`` ('done'/'skipped'/
        'error'/'quarantined', or 'dropped' when preempted — dropped
        items are released, not completed). When pending is empty this
        host steals expired leases; when other hosts still hold live
        leases it idle-waits (the per-host idle tail
        ``fleet.idle_wait`` spans make visible on the trace)."""
        stop = stop if stop is not None else threading.Event()
        errors: List[BaseException] = []

        def loop() -> None:
            while not stop.is_set():
                rec = self.claim_next()
                if rec is None:
                    if self.reclaim_expired() > 0:
                        continue
                    if self.all_done():
                        return
                    with trace.span("fleet.idle_wait"):
                        t_idle = time.perf_counter()
                        stop.wait(poll_s)
                        with self._lock:
                            self._idle_wait_s += \
                                time.perf_counter() - t_idle
                    continue
                video = rec.get("video")
                t0 = time.perf_counter()
                try:
                    status = run_fn(str(video))
                except BaseException as e:
                    # an ESCAPED exception is a caller bug, not a video
                    # verdict: hand the item back for another host
                    self.release(rec)
                    errors.append(e)
                    return
                if status == "dropped":
                    self.release(rec)
                    return
                self.complete(rec, status,
                              elapsed_s=time.perf_counter() - t0)
                if on_complete is not None:
                    on_complete(rec, status)

        if workers <= 1:
            loop()
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="vft-fleet") as pool:
                for f in [pool.submit(loop) for _ in range(workers)]:
                    f.result()
        if errors:
            raise errors[0]

    # -- canary gating -------------------------------------------------------
    def canary_gate(self, extract_fn, *, slice_n: int = 2,
                    band: float = 1.0, atol: float = 1e-2,
                    rtol: float = 0.02) -> Tuple[bool, List[str]]:
        """Gate a joining host before it may claim freely: re-extract up
        to ``slice_n`` videos that OTHER hosts already completed into a
        private canary dir, then hold the results against

          - **compare_runs.py digest bands**: the canary's feature
            digests (health=true) must sit inside the same atol/rtol
            bands compare_runs applies between runs — a new binary or
            config that drifts the numerics fails here, on throwaway
            output, instead of inside the shared run;
          - **bench_history.py timing bands**: the canary's best
            seconds-per-video vs the fleet's recorded times for the same
            videos, through check_regressions' banding (generous default
            ``band=1.0`` = 2x: a joining host pays its cold build).

        ``extract_fn(video, out_dir) -> (status, elapsed_s)`` is supplied
        by the caller (cli.py builds a cache-disabled extractor pointed
        at the canary dir). A founding member — no completed work by
        other hosts yet — passes trivially: there is nothing to compare
        against, and the run-level health gates still apply."""
        self._canary_state = "running"
        lines: List[str] = []
        if self.canary_warm:
            # warm fast path (compile_cache.py): the generous default
            # timing band exists to absorb a joining host's cold kernel
            # build; a warm entry means there is none to absorb, so the
            # allowance is skipped and the gate held to the tight band
            band = min(float(band), WARM_CANARY_BAND)
            lines.append("fleet canary: compile cache warm (entry warm "
                         "at attach) — cold-build allowance removed, "
                         f"timing band tightened to {band:.0%}")
        sample = []
        try:
            names = sorted(n for n in os.listdir(self._p(DONE))
                           if n.endswith(".json"))
        except OSError:
            names = []
        for name in names:
            rec = _read_json(self._p(DONE, name))
            if rec is None or rec.get("by") == self.host_id:
                continue
            if rec.get("status") != "done" or not rec.get("video"):
                continue
            if os.path.exists(str(rec["video"])):
                sample.append(rec)
        if not sample:
            self._canary_state = "founding"
            return True, ["fleet canary: founding member — no completed "
                          "work by other hosts yet, claims open"]
        sample = sample[-int(slice_n):]
        # fresh subdir per attempt: a rerun must re-extract, not ride the
        # sinks' skip-if-exists over a previous attempt's output
        canary_dir = self._p("canary", _safe(self.host_id),
                             uuid.uuid4().hex[:8])
        os.makedirs(canary_dir, exist_ok=True)
        results = []
        for rec in sample:
            with trace.span("fleet.canary", item=str(rec.get("id"))):
                status, elapsed = extract_fn(str(rec["video"]), canary_dir)
            results.append((rec, status, elapsed))
            lines.append(f"fleet canary: {Path(str(rec['video'])).name} -> "
                         f"{status} in {elapsed:.2f}s (fleet did it in "
                         f"{rec.get('elapsed_s', '?')}s)")
        ok = all(status == "done" for _, status, _ in results)
        if not ok:
            lines.append("fleet canary: FAILED — canary extraction did not "
                         "complete cleanly")
        ok = self._canary_digests(canary_dir, atol, rtol, lines) and ok
        ok = self._canary_timing(canary_dir, results, band, lines) and ok
        verdict = {"schema": "vft.fleet_canary/1", "host_id": self.host_id,
                   "run_id": self.run_id, "ok": bool(ok),
                   "canary_warm": bool(self.canary_warm),
                   "videos": [str(r.get("video")) for r, _, _ in results],
                   "time": round(self.clock(), 3), "lines": lines}
        write_json_atomic(self._p("canary", f"{_safe(self.host_id)}.json"),
                          verdict)
        self._canary_state = "passed" if ok else "failed"
        return ok, lines

    def _load_fleet_health(self) -> Dict[Tuple[str, str, str], dict]:
        """The fleet's digests, EXCLUDING everything under the queue dir
        (canary output lives there — comparing it against itself would
        make the gate vacuous)."""
        from ..telemetry.health import HEALTH_FILENAME
        qroot = Path(self.root).resolve()
        out: Dict[Tuple[str, str, str], dict] = {}
        for path in sorted(Path(self.out_root).rglob(HEALTH_FILENAME)):
            if qroot in path.resolve().parents:
                continue
            for rec in read_jsonl(path):
                k = (os.path.basename(str(rec.get("video"))),
                     str(rec.get("feature_type")), str(rec.get("key")))
                out[k] = rec
        return out

    def _canary_digests(self, canary_dir: str, atol: float, rtol: float,
                        lines: List[str]) -> bool:
        da = self._load_fleet_health()
        db = load_health(canary_dir)
        fails, infos, n = compare_digests(da, db, atol, rtol)
        if n == 0:
            lines.append("fleet canary: no overlapping health digests "
                         "(run with health=true fleet-wide for digest "
                         "gating) — digest gate vacuous")
            return True
        lines += [f"fleet canary: DIGEST DRIFT {x}" for x in fails]
        lines.append(f"fleet canary: {n} digest(s) compared against "
                     f"compare_runs bands (atol={atol}, rtol={rtol}) — "
                     + ("PASS" if not fails else "FAIL"))
        return not fails

    def _canary_timing(self, canary_dir: str, results, band: float,
                       lines: List[str]) -> bool:
        fleet_times = [float(r.get("elapsed_s", 0) or 0)
                       for r, _, _ in results]
        my_times = [float(e) for _, status, e in results
                    if status in ("done", "skipped")]
        fleet_times = [t for t in fleet_times if t > 0]
        if not fleet_times or not my_times:
            lines.append("fleet canary: timing gate skipped "
                         "(no comparable timings)")
            return True
        fleet_med = sorted(fleet_times)[len(fleet_times) // 2]
        # best canary video: the first one carries this host's cold
        # build and weights tax, which is a join cost, not a speed verdict
        mine = min(my_times)
        hist = os.path.join(canary_dir, "_canary_history.jsonl")
        try:
            os.unlink(hist)
        except OSError:
            pass
        metric = "fleet canary seconds per video"
        for rnd, val, src in ((1, fleet_med, "fleet"),
                              (2, mine, self.host_id)):
            append_jsonl(hist, {
                "schema": HISTORY_SCHEMA, "round": rnd, "source": src,
                "recorded_time": round(self.clock(), 3),
                "headline": {"metric": metric, "value": round(val, 3),
                             "unit": "seconds per video",
                             "vs_baseline": None},
                "metrics": []})
        regressions, rep = check_regressions(hist, band)
        lines += [f"fleet canary: {x}" for x in rep[1:]]
        lines.append(f"fleet canary: timing band ({band:.0%}) via "
                     "bench_history check — "
                     + ("PASS" if not regressions else "FAIL"))
        return not regressions


# -- the canary's timing band: the port's copy of scripts/bench_history.py
#    (load_history, series, check_regressions); its digest band is
#    compare_runs.py's (load_health, compare_digests) ------------------------

def load_history(path: str) -> List[dict]:
    return [r for r in read_jsonl(path)
            if r.get("schema") == HISTORY_SCHEMA]


def _rows(rec: dict) -> List[dict]:
    rows = []
    h = rec.get("headline") or {}
    if h.get("metric") is not None and h.get("value") is not None:
        rows.append(h)
    rows += [m for m in rec.get("metrics", []) if m.get("value") is not None]
    return rows


def _lower_is_better(metric: str, unit: str) -> bool:
    text = f"{metric} {unit}".lower()
    if "mfu" in text or "tflops" in text:
        return False
    return "overhead" in text or "wall-clock" in text \
        or "seconds per" in text


def series(history: List[dict]) -> Dict[str, List[Tuple[int, float, str]]]:
    """metric name -> [(round, value, unit)] sorted by round."""
    out: Dict[str, List[Tuple[int, float, str]]] = {}
    for rec in sorted(history, key=lambda r: r.get("round") or 0):
        rnd = rec.get("round") or 0
        for row in _rows(rec):
            try:
                v = float(row["value"])
            except (TypeError, ValueError):
                continue
            out.setdefault(str(row["metric"]), []).append(
                (rnd, v, str(row.get("unit") or "")))
    return out


def check_regressions(path: str, band: float
                      ) -> Tuple[List[str], List[str]]:
    """(regressions, report lines) comparing each metric's newest round
    against its previous one, ``band`` the relative noise band (a
    ``seconds per`` metric regresses up, a throughput down)."""
    history = load_history(path)
    if len(history) < 2:
        return [], [f"bench history: {len(history)} round(s) in {path} — "
                    "need 2+ to compare"]
    lines: List[str] = [f"bench history: {len(history)} round(s) in {path}"]
    regressions: List[str] = []
    for metric, pts in sorted(series(history).items()):
        if len(pts) < 2:
            lines.append(f"  new   {metric}: {pts[-1][1]:g} {pts[-1][2]} "
                         f"(round {pts[-1][0]}, no prior round)")
            continue
        (prev_r, prev_v, _), (last_r, last_v, unit) = pts[-2], pts[-1]
        if prev_v == 0:
            continue
        ratio = last_v / prev_v
        worse = ratio > 1.0 + band if _lower_is_better(metric, unit) \
            else ratio < 1.0 - band
        tag = "REGRESSION" if worse else "ok"
        lines.append(
            f"  {tag:<10} {metric}: {prev_v:g} -> {last_v:g} {unit} "
            f"({ratio:.2f}x, rounds {prev_r}->{last_r})")
        if worse:
            regressions.append(
                f"{metric}: {prev_v:g} -> {last_v:g} {unit} "
                f"({ratio:.2f}x, beyond the {band:.0%} noise band)")
    return regressions, lines
