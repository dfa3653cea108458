"""The run-invariant auditor (port of ``video_features_tpu/audit.py``).

    python -m video_features_tpu_torch audit ROOT [--cache-dir DIR]
                                                  [--expect-complete]

Reads a finished or killed output tree and gives one PASS or FAIL verdict
on the invariants that the durability machinery promises under any
interleaving of crashes (``docs/chaos.md`` has the list with its
rationale):

  1. no ``.tmp`` litter: every writer renames a fsynced temp file into
     place and unlinks it on failure (``utils/sinks.py``,
     ``telemetry/jsonl.py``, ``serve.py``);
  2. at most one torn record per ``.jsonl`` file, and only at its tail
     (single-write ``O_APPEND`` records);
  3. a fleet-queue ``done/`` marker of status done or skipped has loadable
     artifacts for its video; status error has a failure-journal record;
  4. no claim left behind by a host that wrote a final heartbeat (a stale
     owner's claims are recoverable by lease steal: notes);
  5. with ``--expect-complete`` (a drained run) ``pending/`` and
     ``claimed/`` are empty; a ``.staging/`` item without a done marker is
     stranded once no live host remains to sweep it;
  6. every quarantined item has a POISON failure-journal record;
  7. each ``_health.jsonl`` digest recomputes from its artifact, and a
     record with NaN or Inf has no artifact;
  8. each span's ``artifact`` event (bytes and sha256 of what was renamed
     into place) matches the file on disk;
  9. every feature-cache entry loads, has the current schema and matches
     its stored signatures (``--cache-dir``, or a manifest naming one);
 10. the spool and the gateway reconcile: ``expired/`` records carry
     ``deadline_exceeded`` and exclude ``done/``; a request expired at
     claim produced no span; every ``inbox/`` upload has a journal record;
     requests refused at the door never reached the spool; per-tenant
     accepted counts equal the terminal markers;
 11. gc deletions reconcile with their journal (``gc.py``): a journaled
     path still on disk is a note (the sweep died in the crash window),
     a journaled spool or inbox deletion that a live request can still
     reach is a violation;
 12. every ``_scenario.json`` drill verdict agrees with itself and with the
     loadgen journal it names.

Violations are states the machinery promises cannot happen; notes are
in-flight states a killed run may leave. Exit 0 on PASS (no violation), 1
on FAIL. The wording of each violation and note is the JAX package's, so
one grep serves both packages' trees.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# the drill verdict's schema, from ``loadgen.py``, which writes the
# ``_scenario.json`` files this audit reads
from .loadgen import SCENARIO_SCHEMA

ARTIFACT_EXTS = (".npy", ".pkl")


class Audit:
    """One audit pass over an output root; collects violations and
    notes."""

    def __init__(self, root: str, *, cache_dir: Optional[str] = None,
                 expect_complete: bool = False) -> None:
        self.root = Path(root)
        self.cache_dir = cache_dir
        self.expect_complete = bool(expect_complete)
        self.violations: List[str] = []
        self.notes: List[str] = []
        self.stats: Dict[str, int] = {}
        self._journal_files: List[Path] = []

    def violation(self, msg: str) -> None:
        self.violations.append(msg)

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    # -- helpers ------------------------------------------------------------
    def _rel(self, p: Path) -> str:
        try:
            return str(p.relative_to(self.root))
        except ValueError:
            return str(p)

    def _load_artifact(self, path: Path):
        import numpy as np
        if path.suffix == ".npy":
            return np.load(path, allow_pickle=False)
        with open(path, "rb") as f:
            return pickle.load(f)

    def _journal_records(self) -> Dict[str, dict]:
        """The latest failure-journal record per video, across every
        ``_failures.jsonl`` under the root (a multi-family run keeps one per
        family directory); the last record wins, as ``FailureJournal``
        reads it."""
        from .telemetry.jsonl import read_jsonl
        out: Dict[str, dict] = {}
        self._journal_files = sorted(self.root.rglob("_failures.jsonl"))
        for path in self._journal_files:
            for rec in read_jsonl(path):
                v = rec.get("video")
                if v is not None:
                    out[str(v)] = rec
        return out

    # -- invariant 1: no .tmp litter ----------------------------------------
    def check_tmp_litter(self) -> None:
        tmps = sorted(self.root.rglob("*.tmp"))
        self.stats["tmp_files"] = len(tmps)
        for p in tmps:
            self.violation(
                f"tmp litter: {self._rel(p)} — a temp+rename writer leaked "
                "its scratch file (missing unlink-on-failure)")

    # -- invariant 2: jsonl torn tails only ---------------------------------
    def check_jsonl(self) -> None:
        files = sorted(self.root.rglob("*.jsonl"))
        self.stats["jsonl_files"] = len(files)
        for path in files:
            try:
                raw_lines = path.read_bytes().split(b"\n")
            except OSError as e:
                self.violation(f"{self._rel(path)}: unreadable ({e})")
                continue
            # a trailing newline yields one empty final element
            if raw_lines and raw_lines[-1] == b"":
                raw_lines.pop()
            bad = []
            for i, raw in enumerate(raw_lines):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    json.loads(raw.decode("utf-8", errors="replace"))
                except ValueError:
                    bad.append(i)
            for i in bad:
                if i == len(raw_lines) - 1:
                    self.note(f"{self._rel(path)}: torn trailing record "
                              "(healable: the next append repairs it)")
                else:
                    self.violation(
                        f"{self._rel(path)}: corrupt record at line {i + 1} "
                        f"of {len(raw_lines)} — mid-file tears cannot happen "
                        "under single-write O_APPEND records")

    # -- invariants 3-6: fleet queue state ----------------------------------
    def _read_json(self, path: Path) -> Optional[dict]:
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except (OSError, ValueError):
            return None

    def _heartbeats(self, out_root: Path) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for p in sorted(out_root.glob("_heartbeat_*.json")):
            hb = self._read_json(p)
            if hb is not None:
                out[str(hb.get("host_id") or p.stem)] = hb
        return out

    def check_queue(self, journal: Dict[str, dict]) -> None:
        from .telemetry.heartbeat import heartbeat_filename
        queues = sorted(p for p in self.root.rglob("_queue")
                        if p.is_dir())
        self.stats["queues"] = len(queues)
        for q in queues:
            out_root = q.parent
            hbs = self._heartbeats(out_root)
            all_final = bool(hbs) and all(hb.get("final") for hb in
                                          hbs.values())
            done: Dict[str, dict] = {}
            for p in sorted((q / "done").glob("*.json")):
                rec = self._read_json(p)
                if rec is None:
                    self.violation(f"{self._rel(p)}: unparseable done "
                                   "marker — done markers are single-write "
                                   "O_EXCL files and cannot tear")
                    continue
                done[p.stem] = rec
            self.stats["done_markers"] = \
                self.stats.get("done_markers", 0) + len(done)

            # 3: done/skipped => artifacts; error => journal record
            for iid, rec in done.items():
                video = rec.get("video")
                status = rec.get("status")
                stem = Path(str(video)).stem if video else iid
                arts = [p for ext in ARTIFACT_EXTS
                        for p in out_root.rglob(f"{stem}_*{ext}")]
                if status in ("done", "skipped"):
                    if not arts:
                        self.violation(
                            f"done marker {iid} (status={status}) has no "
                            f"artifact for {stem!r} under "
                            f"{self._rel(out_root)} — completion published "
                            "before the sink's atomic rename landed")
                        continue
                    for a in arts:
                        try:
                            self._load_artifact(a)
                        except Exception as e:
                            self.violation(
                                f"done marker {iid}: artifact "
                                f"{self._rel(a)} does not load "
                                f"({type(e).__name__}: {e}) — atomic sinks "
                                "cannot leave torn outputs")
                elif status == "error":
                    if journal and str(video) not in journal:
                        self.violation(
                            f"done marker {iid} reports status=error but "
                            f"no failure journal records {video!r} — every "
                            "terminal failure must be journaled")
                    if not self._journal_files:
                        self.note(f"done marker {iid} status=error with no "
                                  "journal present (print sink?)")

            # 4: claims against their owners' heartbeats
            claimed_root = q / "claimed"
            if claimed_root.is_dir():
                for host_dir in sorted(claimed_root.iterdir()):
                    if not host_dir.is_dir():
                        continue
                    claims = sorted(host_dir.glob("*.json"))
                    if not claims:
                        continue
                    hb = self._read_json(
                        out_root / heartbeat_filename(host_dir.name))
                    owner = host_dir.name
                    if hb is not None and hb.get("final"):
                        for c in claims:
                            self.violation(
                                f"orphaned claim {self._rel(c)}: owner "
                                f"{owner} wrote a FINAL heartbeat — a "
                                "graceful exit must release or complete "
                                "every claim (cli.py release_all)")
                    elif self.expect_complete:
                        for c in claims:
                            self.violation(
                                f"leftover claim {self._rel(c)} after a "
                                f"supposedly drained run (owner {owner})")
                    else:
                        self.note(f"{len(claims)} in-flight claim(s) held "
                                  f"by {owner} (owner not finalized — "
                                  "recoverable by lease steal)")
                    for c in claims:
                        if c.stem in done:
                            self.note(f"claim {self._rel(c)} duplicates a "
                                      "done marker (recoverable: claimants "
                                      "discard against done)")

            # 5: pending and staging strandedness
            pending = sorted((q / "pending").glob("*.json"))
            if pending and self.expect_complete:
                for p in pending:
                    self.violation(f"pending item {self._rel(p)} after a "
                                   "supposedly drained run")
            for p in pending:
                if p.stem in done:
                    self.note(f"pending item {self._rel(p)} duplicates a "
                              "done marker (recoverable: discarded at "
                              "next claim)")
            staging = sorted((q / ".staging").glob("*.json"))
            for p in staging:
                rec = self._read_json(p) or {}
                iid = str(rec.get("id") or "")
                if iid and iid in done:
                    self.note(f"staging leftover {self._rel(p)} for a done "
                              "item (dead weight; swept later)")
                elif all_final or self.expect_complete:
                    self.violation(
                        f"item stranded in staging: {self._rel(p)} has no "
                        "done marker and no live host remains to sweep it "
                        "back to pending — the work is lost")
                else:
                    self.note(f"staging in-flight: {self._rel(p)} "
                              "(recoverable by the orphan sweep)")

            # 6: quarantined => POISON journal record
            for p in sorted((q / "quarantined").glob("*.json")):
                rec = self._read_json(p)
                video = (rec or {}).get("video")
                jrec = journal.get(str(video)) if video else None
                if jrec is None or jrec.get("category") != "POISON":
                    self.violation(
                        f"quarantined item {self._rel(p)} "
                        f"(video={video!r}) has no POISON record in any "
                        "failure journal — retry_failed=true could never "
                        "lift it and restarted workers would re-dispatch")

    # -- invariant 10: the gateway and spool lifecycle reconciles -----------
    def _span_request_counts(self) -> Dict[str, int]:
        """``{request_id: span_count}`` over every span file under the
        root: the evidence for 'expired at claim = zero work'."""
        from .telemetry.jsonl import read_jsonl
        out: Dict[str, int] = {}
        for spath in sorted(self.root.rglob("_telemetry.jsonl")):
            for rec in read_jsonl(spath):
                rid = rec.get("request_id")
                if rid:
                    out[str(rid)] = out.get(str(rid), 0) + 1
        return out

    def check_spools(self) -> None:
        from .telemetry.jsonl import read_jsonl
        spools = sorted({p.parent for p in self.root.rglob("requests")
                         if p.is_dir() and (p.parent / "done").is_dir()
                         and (p.parent / "claimed").is_dir()})
        if not spools:
            return
        self.stats["spools"] = len(spools)
        span_counts: Optional[Dict[str, int]] = None  # computed lazily
        for spool in spools:
            done_ids = {p.stem for p in (spool / "done").glob("*.json")}
            expired_dir = spool / "expired"
            expired_files = (sorted(expired_dir.glob("*.json"))
                             if expired_dir.is_dir() else [])
            self.stats["expired_records"] = \
                self.stats.get("expired_records", 0) + len(expired_files)
            for p in expired_files:
                rec = self._read_json(p)
                rid = p.stem
                if rec is None or rec.get("status") != "deadline_exceeded":
                    self.violation(
                        f"{self._rel(p)}: expired record must carry "
                        f"status=deadline_exceeded "
                        f"(got {(rec or {}).get('status')!r})")
                    continue
                if rid in done_ids:
                    self.violation(
                        f"request {rid}: BOTH a done/ response and an "
                        "expired/ record exist — deadline_exceeded and "
                        "completion are mutually exclusive terminal "
                        "states (serve.py)")
                if int(rec.get("processed") or 0) == 0:
                    if span_counts is None:
                        span_counts = self._span_request_counts()
                    if span_counts.get(rid):
                        self.violation(
                            f"request {rid}: expired at claim "
                            f"(processed=0) yet produced "
                            f"{span_counts[rid]} video span(s) — the "
                            "wasted-work guard must cancel BEFORE any "
                            "decode/device time burns")

            journals = sorted(spool.glob("_gateway_*.jsonl"))
            if not journals:
                continue
            self.stats["gateway_journals"] = \
                self.stats.get("gateway_journals", 0) + len(journals)
            events = [rec for j in journals for rec in read_jsonl(j)]

            # no orphaned uploads: every inbox file came through the
            # journaled, content-addressed upload path
            journaled = {os.path.basename(str(rec.get("path")))
                         for rec in events
                         if rec.get("event") == "upload" and rec.get("path")}
            inbox = spool / "inbox"
            if inbox.is_dir():
                files = [p for p in sorted(inbox.iterdir()) if p.is_file()]
                self.stats["inbox_files"] = \
                    self.stats.get("inbox_files", 0) + len(files)
                for p in files:
                    if p.name not in journaled:
                        self.violation(
                            f"orphaned upload {self._rel(p)}: no gateway "
                            "journal record names it — every inbox file "
                            "must arrive through the journaled upload "
                            "path (gateway.py store_upload)")

            accepted: Dict[str, str] = {}
            refused: List[str] = []
            for rec in events:
                ev, rid = rec.get("event"), rec.get("id")
                if not rid:
                    continue
                if ev == "accepted":
                    accepted[str(rid)] = str(rec.get("tenant"))
                elif ev in ("rejected", "shed"):
                    refused.append(str(rid))
            expired_ids = {p.stem for p in expired_files}
            for rid in sorted(refused):
                if rid in done_ids or rid in expired_ids or \
                        (spool / "requests" / f"{rid}.json").exists():
                    self.violation(
                        f"request {rid} was refused (429/503) at the "
                        "gateway door yet reached the spool — a refused "
                        "request must produce no work")

            # per tenant: accepted == terminal, rid by rid
            per_tenant: Dict[str, Dict[str, int]] = {}
            for rid, tenant in sorted(accepted.items()):
                t = per_tenant.setdefault(tenant,
                                          {"accepted": 0, "terminal": 0})
                t["accepted"] += 1
                if rid in done_ids or rid in expired_ids:
                    t["terminal"] += 1
                elif self.expect_complete:
                    self.violation(
                        f"gateway-accepted request {rid} (tenant "
                        f"{tenant}) has no terminal record — every 202 "
                        "must resolve to a done/ response or an "
                        "expired/ record by drain time")
                else:
                    self.note(f"gateway-accepted request {rid} still "
                              "open (in flight — resolves by response "
                              "or deadline)")
            if self.expect_complete:
                for tenant, t in sorted(per_tenant.items()):
                    if t["accepted"] != t["terminal"]:
                        self.violation(
                            f"tenant {tenant}: {t['accepted']} accepted "
                            f"vs {t['terminal']} terminal — per-tenant "
                            "journal counts must reconcile with the "
                            "spool's done/expired markers")

    # -- invariant 7: health digests re-verify -------------------------------
    def check_health(self) -> None:
        import numpy as np
        from .telemetry.health import HEALTH_FILENAME, content_signature
        from .telemetry.jsonl import read_jsonl
        n_checked = 0
        for hpath in sorted(self.root.rglob(HEALTH_FILENAME)):
            fam_dir = hpath.parent
            latest: Dict[Tuple[str, str], dict] = {}
            for rec in read_jsonl(hpath):
                latest[(str(rec.get("video")), str(rec.get("key")))] = rec
            for (video, key), rec in sorted(latest.items()):
                stem = Path(video).stem
                art = None
                for ext in ARTIFACT_EXTS:
                    cand = fam_dir / f"{stem}_{key}{ext}"
                    if cand.exists():
                        art = cand
                        break
                nonfinite = int(rec.get("nan") or 0) + int(rec.get("inf")
                                                           or 0)
                if art is None:
                    if nonfinite == 0:
                        self.note(f"health digest for ({stem}, {key}) has "
                                  f"no artifact in {self._rel(fam_dir)} "
                                  "(print sink, or killed pre-write — "
                                  "digests are taken before the sink)")
                    continue
                if nonfinite:
                    self.violation(
                        f"{self._rel(art)}: health recorded {rec.get('nan')}"
                        f" NaN / {rec.get('inf')} Inf for this tensor, yet "
                        "an artifact exists — the non-finite gate must "
                        "refuse the write (telemetry/health.py)")
                    continue
                try:
                    value = self._load_artifact(art)
                except Exception as e:
                    self.violation(f"{self._rel(art)}: does not load "
                                   f"({type(e).__name__}: {e})")
                    continue
                got = content_signature(np.asarray(value))
                if got != rec.get("sig"):
                    self.violation(
                        f"{self._rel(art)}: content signature mismatch vs "
                        "its _health.jsonl record — the bytes on disk are "
                        "not the bytes that were digested (rot, tamper, "
                        "or a non-atomic writer)")
                n_checked += 1
        self.stats["health_verified"] = n_checked

    # -- invariant 8: artifact span shas re-verify ---------------------------
    def check_artifact_spans(self) -> None:
        import hashlib
        from .telemetry.jsonl import read_jsonl
        latest: Dict[str, dict] = {}
        for spath in sorted(self.root.rglob("_telemetry.jsonl")):
            for rec in read_jsonl(spath):
                for ev in rec.get("events") or []:
                    if ev.get("kind") == "artifact" and ev.get("file"):
                        latest[str(ev["file"])] = ev
        n_checked = 0
        for fname, ev in sorted(latest.items()):
            matches = sorted(self.root.rglob(fname))
            if not matches:
                self.violation(
                    f"artifact {fname} recorded in a span (bytes="
                    f"{ev.get('bytes')}) but absent on disk — spans emit "
                    "after the atomic rename, so the file must exist")
                continue
            for path in matches:
                try:
                    data = path.read_bytes()
                except OSError as e:
                    self.violation(f"{self._rel(path)}: unreadable ({e})")
                    continue
                if ev.get("bytes") is not None and \
                        len(data) != int(ev["bytes"]):
                    self.violation(
                        f"{self._rel(path)}: {len(data)} bytes on disk vs "
                        f"{ev['bytes']} recorded — truncated or replaced "
                        "by a non-identical writer")
                    continue
                if ev.get("sha256") and \
                        hashlib.sha256(data).hexdigest() != ev["sha256"]:
                    self.violation(
                        f"{self._rel(path)}: sha256 differs from the span "
                        "record of what was renamed into place")
                n_checked += 1
        self.stats["artifact_spans_verified"] = n_checked

    # -- invariant 9: cache entries re-verify --------------------------------
    def _discover_cache_dir(self) -> Optional[str]:
        if self.cache_dir:
            return self.cache_dir
        for mpath in sorted(self.root.rglob("_run.json")):
            m = self._read_json(mpath) or {}
            cfgs: List[dict] = []
            rc = m.get("run_config") or {}
            cfgs.append(rc)
            cfgs.extend((rc.get("families") or {}).values())
            for cfg in cfgs:
                if isinstance(cfg, dict) and cfg.get("cache") and \
                        cfg.get("cache_dir"):
                    return str(cfg["cache_dir"])
        return None

    def check_cache(self) -> None:
        import numpy as np
        from .cache import SCHEMA_VERSION
        from .telemetry.health import content_signature
        root = self._discover_cache_dir()
        if root is None:
            return
        if not os.path.isdir(root):
            self.note(f"cache dir {root} does not exist (nothing stored)")
            return
        n_checked = 0
        for path in sorted(Path(root).rglob("*.pkl")):
            try:
                with open(path, "rb") as f:
                    entry = pickle.load(f)
                if entry.get("schema") != SCHEMA_VERSION:
                    raise ValueError(f"schema {entry.get('schema')!r}")
                for k, arr in entry["feats"].items():
                    if content_signature(np.asarray(arr)) != \
                            entry["sigs"].get(k):
                        raise ValueError(f"signature mismatch for {k!r}")
            except Exception as e:
                self.violation(
                    f"cache entry {path} fails re-verification "
                    f"({type(e).__name__}: {e}) — atomic entry writes + "
                    "verify-before-trust promise this never persists")
                continue
            n_checked += 1
        self.stats["cache_entries_verified"] = n_checked

    # -- invariant 11: gc deletions reconcile with their journal ------------
    def check_gc(self) -> None:
        """Every ``_gc_*.jsonl`` evict record either completed (the path is
        gone and, for the spool and inbox, still safe to be gone) or is a
        recoverable journal-then-die remnant (a note)."""
        from .gc import (GC_JOURNAL_GLOB, _claimable_rids,
                         _referenced_inbox_blobs)
        from .telemetry.jsonl import read_jsonl
        journals = sorted(self.root.glob(GC_JOURNAL_GLOB))
        if not journals:
            return
        live_rids = _claimable_rids(str(self.root))
        live_blobs = _referenced_inbox_blobs(str(self.root))
        n_records = n_pending = 0
        for jp in journals:
            for rec in read_jsonl(jp):
                if rec.get("event") != "evict":
                    continue
                n_records += 1
                path = rec.get("path") or ""
                plane = rec.get("plane")
                base = os.path.basename(path)
                if os.path.exists(path):
                    n_pending += 1
                    continue  # journaled but present: noted below
                # deleted: its safety rule must still hold now
                if plane == "spool" and base.endswith(".json") and \
                        base[:-len(".json")] in live_rids:
                    self.violation(
                        f"gc journal {jp.name} deleted spool response "
                        f"{base} whose request is claimable — the "
                        "claimable-rid rule (gc.py plan_spool) promises "
                        "this never happens")
                elif plane == "inbox" and base in live_blobs:
                    self.violation(
                        f"gc journal {jp.name} deleted inbox blob {base} "
                        "still referenced by a live request — the "
                        "reference rule (gc.py plan_inbox) promises this "
                        "never happens")
        if n_pending:
            self.note(
                f"{n_pending} gc-journaled deletion(s) not yet on disk "
                "— the GC died between journal and unlink; the next "
                "vft-gc run re-plans and completes them (recoverable)")
        self.stats["gc_journal_records"] = n_records

    # -- invariant 12: drill verdicts ---------------------------------------
    def check_scenarios(self) -> None:
        """Every ``_scenario.json`` drill verdict is consistent in itself
        and with the loadgen journal it names: the offered count equals the
        journal's request events, per-tenant tallies sum to the headline
        numbers, and a PASS never sits on a recorded audit failure."""
        from .telemetry.jsonl import read_jsonl
        n = 0
        for sp in sorted(self.root.rglob("_scenario.json")):
            doc = self._read_json(sp)
            if doc is None:
                self.violation(f"{self._rel(sp)}: unreadable")
                continue
            n += 1
            if doc.get("schema") != SCENARIO_SCHEMA:
                self.violation(
                    f"{self._rel(sp)}: schema {doc.get('schema')!r} != "
                    f"{SCENARIO_SCHEMA!r}")
                continue
            tens = doc.get("tenants") or {}
            for k in ("offered", "admitted", "completed", "expired",
                      "rejected", "shed", "errors"):
                want = sum(int(tb.get(k) or 0) for tb in tens.values())
                if int(doc.get(k) or 0) != want:
                    self.violation(
                        f"{self._rel(sp)}: headline {k}="
                        f"{doc.get(k)} != per-tenant sum {want}")
            parts = sum(int(doc.get(k) or 0)
                        for k in ("admitted", "rejected", "shed",
                                  "errors"))
            if parts != int(doc.get("offered") or 0):
                self.violation(
                    f"{self._rel(sp)}: admitted+rejected+shed+errors="
                    f"{parts} != offered={doc.get('offered')} — every "
                    "offered request has exactly one door outcome")
            jp = sp.parent / str(doc.get("journal") or "")
            if doc.get("journal") and jp.is_file():
                reqs = sum(1 for rec in read_jsonl(jp)
                           if rec.get("event") == "request")
                if reqs != int(doc.get("offered") or 0):
                    self.violation(
                        f"{self._rel(sp)}: offered={doc.get('offered')} "
                        f"but the loadgen journal {jp.name} records "
                        f"{reqs} request event(s)")
            elif doc.get("journal"):
                self.note(f"{self._rel(sp)}: journal "
                          f"{doc.get('journal')} not found beside the "
                          "artifact — offered count unverifiable")
            if doc.get("verdict") == "PASS" and \
                    not (doc.get("audit") or {}).get("pass"):
                self.violation(
                    f"{self._rel(sp)}: verdict PASS over a recorded "
                    "audit failure — the drill gate requires both")
        if n:
            self.stats["scenario_artifacts"] = n

    # -- driver --------------------------------------------------------------
    def run(self) -> bool:
        if not self.root.is_dir():
            self.violation(f"{self.root}: not a directory")
            return False
        journal = self._journal_records()
        self.stats["journal_records"] = len(journal)
        self.check_tmp_litter()
        self.check_jsonl()
        self.check_queue(journal)
        self.check_spools()
        self.check_health()
        self.check_artifact_spans()
        self.check_cache()
        self.check_gc()
        self.check_scenarios()
        return not self.violations


def audit_run(root: str, *, cache_dir: Optional[str] = None,
              expect_complete: bool = False
              ) -> Tuple[bool, List[str], List[str]]:
    """The library entry point: ``(ok, violations, notes)``."""
    a = Audit(root, cache_dir=cache_dir, expect_complete=expect_complete)
    ok = a.run()
    return ok, a.violations, a.notes


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch audit",
        description="Audit a (finished or killed) extraction output "
                    "directory against the cross-subsystem durability "
                    "invariants (docs/chaos.md).")
    ap.add_argument("root", help="output directory to audit (the CLI's "
                                 "output_path, or the root above it for "
                                 "multi-family runs)")
    ap.add_argument("--cache-dir", default=None,
                    help="feature-cache root to re-verify (default: "
                         "discovered from _run.json manifests)")
    ap.add_argument("--expect-complete", action="store_true",
                    help="the run claims to have drained: leftover "
                         "pending/claimed queue entries become violations")
    args = ap.parse_args(argv)
    a = Audit(args.root, cache_dir=args.cache_dir,
              expect_complete=args.expect_complete)
    ok = a.run()
    print(f"audit: {args.root}")
    stat_line = ", ".join(f"{k}={v}" for k, v in sorted(a.stats.items()))
    if stat_line:
        print(f"  checked: {stat_line}")
    for v in a.violations:
        print(f"  VIOLATION: {v}")
    for n in a.notes:
        print(f"  note: {n}")
    print(f"AUDIT: {'PASS' if ok else 'FAIL'} "
          f"({len(a.violations)} violation(s), {len(a.notes)} note(s))")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
