"""Seeded, replayable traffic drills (port of
``video_features_tpu/loadgen.py``).

    python -m video_features_tpu_torch loadgen SCENARIO.yml [...] \
        --spool SPOOL --base-url http://127.0.0.1:PORT
    python -m video_features_tpu_torch loadgen SCENARIO.yml --spool SPOOL \
        --dry-run                        # the offered journal only
    python -m video_features_tpu_torch loadgen SCENARIO.yml --spool SPOOL \
        --emit-tenants tenants.yml       # the gateway's tenant table

Turns checked-in scenario specs (``scenarios/*.yml``) into deterministic,
seeded request trains driven through the port's ``gateway`` HTTP front
door, and turns each run into a recorded drill: the offered traffic is
journaled (``_loadgen_{host}.jsonl``, schema ``vft.loadgen_event/1``), and
at exit the journal is joined against the gateway admission journal, the
spool ``done/`` and ``expired/`` terminals, retained history
(``telemetry/history.py``) and the alert journal into a per-scenario
verdict artifact ``_scenario.json`` (schema ``vft.scenario/1``): offered,
admitted and completed per tenant, p50/p95/p99 wait and service, the SLO
attainment curve over the scenario timeline, shed, 429 and expired
accounting, and a PASS/FAIL verdict gated on the port's audit
(``audit.py``) plus the scenario's declared objectives.

Determinism: the offered journal is a pure function of (spec, seed). Every
random draw comes from a named per-scenario stream
(``random.Random(f"{seed}:{scenario}:{stream}")``), so a composed second
scenario never perturbs the first one's events, and the journal is byte
for byte the JAX package's for the same spec and seed. Run-dependent facts
(HTTP status codes, measured waits) are never journaled: they live in the
gateway journal and the spool terminals, which the exit join reads.

Clocks: scenarios are written in virtual seconds. ``clock: virtual``
compresses wall time by ``speedup``; ``clock: wall`` is ``speedup = 1``.
Arrival gaps and request ``timeout_s`` divide by ``speedup`` on the wire
and measured wall durations multiply back; :func:`write_tenant_table`
scales the gateway's ``rate_rps`` the same way, so the wall-clock token
buckets apply the virtual quota. A scenario's ``inject:`` key is the
fault plan DSL (``utils/inject.py``), armed for the run when the gateway
and the server share this process.

Imports neither torch nor numpy at module level, so the ``loadgen``
subcommand starts as fast as ``gc`` and ``audit`` do.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import socket
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from . import serve
from .telemetry import jsonl
from .telemetry.metrics import MetricsRegistry

JOURNAL_PREFIX = "_loadgen_"
SCENARIO_FILENAME = "_scenario.json"

SCHEMA_VERSION = "vft.loadgen_event/1"
SCENARIO_SCHEMA = "vft.scenario/1"

#: journal event vocabulary (the schema's enum)
EVENTS = ("begin", "request", "end")

#: verdict vocabulary (scenario schema enum)
VERDICTS = ("PASS", "FAIL")

#: every key a ``vft.loadgen_event/1`` journal record may carry: the
#: properties of telemetry/loadgen_event.schema.json
LOADGEN_FIELDS = ("schema", "scenario", "seed", "seq", "t", "event", "id",
                  "tenant", "klass", "videos", "timeout_s", "slow_bps",
                  "spec_sha", "offered")

#: top-level keys of the ``_scenario.json`` verdict artifact: the
#: properties of telemetry/scenario.schema.json
SCENARIO_FIELDS = ("schema", "time", "scenario", "scenarios", "clock",
                   "speedup", "duration_s", "slo_s", "host_id", "journal",
                   "offered", "admitted", "completed", "expired",
                   "rejected", "shed", "errors", "tenants", "latency",
                   "curve", "history", "alerts", "audit", "objectives",
                   "verdict")

ARRIVAL_PROCESSES = ("constant", "diurnal", "burst")

#: objective keys a scenario may declare (besides the optional
#: ``tenant`` scope); unknown keys fail at load, not at verdict time
OBJECTIVE_KEYS = ("min_attainment_pct", "min_admitted_pct",
                  "max_shed_pct", "max_rejected_pct", "min_rejected",
                  "min_expired", "max_expired_pct", "min_completed")


def journal_filename(host_id: str) -> str:
    """``_loadgen_{host_id}.jsonl``, sanitized like the heartbeat and
    history filenames (host ids embed hostnames and pids)."""
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(host_id))
    return f"{JOURNAL_PREFIX}{safe}.jsonl"


# -- scenario specs ----------------------------------------------------------

def _bad(path: str, msg: str) -> ValueError:
    return ValueError(f"{path}: {msg}")


def load_scenario(path: str) -> Dict[str, Any]:
    """Parse + validate one scenario YAML into a normalized spec dict.

    Raises ``ValueError`` naming the file and the offending key, so a
    typo'd scenario fails at launch — the same discipline as the
    gateway tenant table and the inject plan DSL."""
    import yaml
    with open(path, encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise _bad(path, "scenario spec must be a mapping")
    name = raw.get("scenario")
    if not isinstance(name, str) or not re.fullmatch(r"[a-z0-9_]+", name):
        raise _bad(path, "needs scenario: <name> matching [a-z0-9_]+")
    if not isinstance(raw.get("seed"), int):
        raise _bad(path, "needs an integer seed: (the replay contract)")
    spec: Dict[str, Any] = {
        "scenario": name,
        "seed": int(raw["seed"]),
        "duration_s": float(raw.get("duration_s") or 30.0),
        "clock": str(raw.get("clock") or "virtual"),
        "speedup": float(raw.get("speedup") or 0.0) or None,
        "slo_s": (float(raw["slo_s"]) if raw.get("slo_s") is not None
                  else None),
        "curve_windows": int(raw.get("curve_windows") or 10),
        "retry_max": int(raw.get("retry_max") or 0),
        "inject": raw.get("inject"),
    }
    if spec["duration_s"] <= 0:
        raise _bad(path, "duration_s must be > 0")
    if spec["clock"] not in ("virtual", "wall"):
        raise _bad(path, "clock must be 'virtual' or 'wall'")
    if spec["clock"] == "wall":
        spec["speedup"] = 1.0
    if spec["speedup"] is not None and spec["speedup"] < 1.0:
        raise _bad(path, "speedup must be >= 1")
    if spec["curve_windows"] < 1:
        raise _bad(path, "curve_windows must be >= 1")
    if spec["inject"] is not None:
        from .utils import inject
        inject.parse_plan(str(spec["inject"]))  # validate at load

    arr = raw.get("arrivals") or {}
    proc = str(arr.get("process") or "constant")
    if proc not in ARRIVAL_PROCESSES:
        raise _bad(path, f"arrivals.process must be one of "
                         f"{'/'.join(ARRIVAL_PROCESSES)}")
    rate = float(arr.get("rate_rps") or 1.0)
    if rate <= 0:
        raise _bad(path, "arrivals.rate_rps must be > 0")
    spec["arrivals"] = {"process": proc, "rate_rps": rate}
    if proc == "diurnal":
        d = arr.get("diurnal") or {}
        period = float(d.get("period_s") or spec["duration_s"])
        depth = float(d.get("depth") if d.get("depth") is not None
                      else 0.6)
        if period <= 0 or not (0.0 <= depth < 1.0):
            raise _bad(path, "diurnal needs period_s > 0 and "
                             "0 <= depth < 1")
        spec["arrivals"]["diurnal"] = {"period_s": period, "depth": depth}
    if proc == "burst":
        b = arr.get("burst") or {}
        burst = {"period_s": float(b.get("period_s") or 20.0),
                 "length_s": float(b.get("length_s") or 5.0),
                 "rate_rps": float(b.get("rate_rps") or rate * 10)}
        if burst["period_s"] <= 0 or burst["length_s"] <= 0 \
                or burst["length_s"] > burst["period_s"] \
                or burst["rate_rps"] < 0:
            raise _bad(path, "burst needs 0 < length_s <= period_s and "
                             "rate_rps >= 0")
        spec["arrivals"]["burst"] = burst

    co = raw.get("corpus") or {}
    spec["corpus"] = {"n_items": int(co.get("n_items") or 8),
                      "zipf_s": float(co.get("zipf_s") or 0.0),
                      "videos_per_request": int(
                          co.get("videos_per_request") or 1),
                      "upload": bool(co.get("upload") or False)}
    if spec["corpus"]["n_items"] < 1 or spec["corpus"]["zipf_s"] < 0 \
            or spec["corpus"]["videos_per_request"] < 1:
        raise _bad(path, "corpus needs n_items >= 1, zipf_s >= 0, "
                         "videos_per_request >= 1")

    tens = raw.get("tenants")
    if not isinstance(tens, dict) or not tens:
        raise _bad(path, "needs at least one tenant under tenants:")
    spec["tenants"] = {}
    for tname, t in tens.items():
        if not re.fullmatch(r"[a-z0-9_]+", str(tname)):
            raise _bad(path, f"tenant {tname!r} must match [a-z0-9_]+ "
                             "(gateway id-prefix contract)")
        t = t or {}
        if not isinstance(t.get("key"), str):
            raise _bad(path, f"tenant {tname!r} needs a string 'key'")
        tt = {"key": t["key"],
              "share": float(t.get("share") or 1.0),
              "priority": str(t.get("priority") or "normal"),
              "rate_rps": float(t.get("rate_rps") or 50.0),
              "burst": float(t.get("burst") or 100.0),
              "max_inflight": int(t.get("max_inflight") or 64),
              "slow_bps": (float(t["slow_bps"])
                           if t.get("slow_bps") else None)}
        if tt["share"] <= 0:
            raise _bad(path, f"tenant {tname!r}: share must be > 0")
        if tt["priority"] not in ("high", "normal", "low"):
            raise _bad(path, f"tenant {tname!r}: priority must be "
                             "high/normal/low")
        to = t.get("timeout_s")
        if to is None:
            tt["timeout_s"] = None
        elif isinstance(to, (int, float)):
            tt["timeout_s"] = (float(to), float(to))
        elif isinstance(to, (list, tuple)) and len(to) == 2 \
                and float(to[0]) <= float(to[1]) and float(to[0]) > 0:
            tt["timeout_s"] = (float(to[0]), float(to[1]))
        else:
            raise _bad(path, f"tenant {tname!r}: timeout_s must be a "
                             "positive number or [lo, hi]")
        spec["tenants"][str(tname)] = tt

    spec["objectives"] = []
    for i, obj in enumerate(raw.get("objectives") or []):
        if not isinstance(obj, dict) or not obj:
            raise _bad(path, f"objectives[{i}] must be a mapping")
        unknown = set(obj) - set(OBJECTIVE_KEYS) - {"tenant"}
        if unknown:
            raise _bad(path, f"objectives[{i}]: unknown key(s) "
                             f"{sorted(unknown)}; pick from "
                             f"{OBJECTIVE_KEYS}")
        if obj.get("tenant") is not None \
                and str(obj["tenant"]) not in spec["tenants"]:
            raise _bad(path, f"objectives[{i}]: unknown tenant "
                             f"{obj['tenant']!r}")
        if not set(obj) - {"tenant"}:
            raise _bad(path, f"objectives[{i}] declares no threshold")
        spec["objectives"].append(dict(obj))

    # identity of the spec AS PARSED — replay proof ties the journal to
    # the exact scenario, not just its filename
    spec["spec_sha"] = hashlib.sha256(json.dumps(
        {k: v for k, v in sorted(spec.items()) if k != "spec_sha"},
        sort_keys=True, default=list).encode()).hexdigest()[:16]
    return spec


def write_tenant_table(specs: List[Dict[str, Any]], path: str,
                       speedup: float) -> None:
    """Emit the gateway ``tenants.yml`` for a drill: the scenario's
    *virtual* per-tenant quotas with ``rate_rps`` multiplied by
    ``speedup``, so the gateway's wall-clock token buckets enforce the
    virtual contract under time compression. ``burst`` and
    ``max_inflight`` are counts, not rates — they pass through."""
    from .utils.sinks import _write_bytes_atomic
    merged: Dict[str, Dict[str, Any]] = {}
    for spec in specs:
        for name, t in spec["tenants"].items():
            prev = merged.get(name)
            if prev is not None and prev["key"] != t["key"]:
                raise ValueError(
                    f"composed scenarios disagree on tenant {name!r} key")
            merged[name] = t
    lines = ["tenants:"]
    for name in sorted(merged):
        t = merged[name]
        lines += [f"  {name}:",
                  f"    key: {t['key']}",
                  f"    rate_rps: {t['rate_rps'] * speedup:g}",
                  f"    burst: {t['burst']:g}",
                  f"    max_inflight: {t['max_inflight']}",
                  f"    priority: {t['priority']}"]
    _write_bytes_atomic(path, ("\n".join(lines) + "\n").encode())


# -- deterministic traffic model ---------------------------------------------

def _stream(spec: Dict[str, Any], name: str):
    """A named, scenario-scoped RNG stream. Seeding with the string
    ``"{seed}:{scenario}:{name}"`` (hashed stably by ``random.Random``)
    makes every stream independent: adding a stream — or composing a
    second scenario — never perturbs another stream's draws."""
    import random
    return random.Random(f"{spec['seed']}:{spec['scenario']}:{name}")


def _rate_at(spec: Dict[str, Any], t: float) -> float:
    arr = spec["arrivals"]
    rate = arr["rate_rps"]
    if arr["process"] == "diurnal":
        d = arr["diurnal"]
        # trough = rate*(1-depth) at t=0, peak = rate at period/2
        phase = 0.5 + 0.5 * math.cos(2 * math.pi * t / d["period_s"])
        return rate * (1.0 - d["depth"] * phase)
    if arr["process"] == "burst":
        b = arr["burst"]
        if (t % b["period_s"]) < b["length_s"]:
            return rate + b["rate_rps"]
    return rate


def _max_rate(spec: Dict[str, Any]) -> float:
    arr = spec["arrivals"]
    if arr["process"] == "burst":
        return arr["rate_rps"] + arr["burst"]["rate_rps"]
    return arr["rate_rps"]


def _zipf_cdf(n_items: int, s: float) -> List[float]:
    w = [1.0 / (r ** s) for r in range(1, n_items + 1)]
    total = sum(w)
    cdf, acc = [], 0.0
    for x in w:
        acc += x / total
        cdf.append(acc)
    return cdf


def content_key(spec: Dict[str, Any], rank: int) -> str:
    """Scenario-scoped corpus item name (rank 0 is the hottest item
    under Zipf skew) — scoping by scenario keeps composed journals
    bit-identical to solo runs."""
    return f"{spec['scenario']}-item{rank:04d}"


def offered_events(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The whole offered-traffic schedule for one scenario, in virtual
    time — a pure function of the spec. Arrival times come from
    thinning a Poisson process at the peak rate (so constant, diurnal
    and burst trains share one generator); tenant mix, content
    popularity and deadline spreads each draw from their own stream."""
    arr, ten = _stream(spec, "arrivals"), _stream(spec, "tenants")
    con, dl = _stream(spec, "content"), _stream(spec, "deadlines")
    lam_max = _max_rate(spec)
    duration = spec["duration_s"]
    cdf = _zipf_cdf(spec["corpus"]["n_items"], spec["corpus"]["zipf_s"])
    tnames = list(spec["tenants"])
    shares = [spec["tenants"][t]["share"] for t in tnames]
    total_share = sum(shares)

    def draw_tenant() -> str:
        u, acc = ten.random() * total_share, 0.0
        for tn, sh in zip(tnames, shares):
            acc += sh
            if u <= acc:
                return tn
        return tnames[-1]

    def draw_item() -> str:
        u = con.random()
        for rank, c in enumerate(cdf):
            if u <= c:
                return content_key(spec, rank)
        return content_key(spec, len(cdf) - 1)

    base = {"schema": SCHEMA_VERSION, "scenario": spec["scenario"],
            "seed": spec["seed"]}
    events: List[Dict[str, Any]] = [
        {**base, "seq": 0, "t": 0.0, "event": "begin",
         "spec_sha": spec["spec_sha"]}]
    t, seq = 0.0, 0
    while True:
        t += arr.expovariate(lam_max)
        if t >= duration:
            break
        if arr.random() > _rate_at(spec, t) / lam_max:
            continue  # thinned: the instantaneous rate is below peak
        seq += 1
        tname = draw_tenant()
        tspec = spec["tenants"][tname]
        videos = [draw_item()
                  for _ in range(spec["corpus"]["videos_per_request"])]
        lo_hi = tspec["timeout_s"]
        timeout = (round(dl.uniform(*lo_hi), 3)
                   if lo_hi is not None else None)
        events.append({**base, "seq": seq, "t": round(t, 6),
                       "event": "request",
                       "id": f"{spec['scenario']}-{seq:05d}",
                       "tenant": tname, "klass": tspec["priority"],
                       "videos": videos, "timeout_s": timeout,
                       "slow_bps": tspec["slow_bps"]})
    events.append({**base, "seq": seq + 1, "t": duration, "event": "end",
                   "offered": seq})
    return events


def synthesize_corpus(corpus_dir: str, specs: List[Dict[str, Any]],
                      sample: Optional[str] = None) -> Dict[str, str]:
    """Materialize every scenario's content items as distinct files so
    the Zipf popularity skew reaches the content-addressed planes
    (gateway inbox dedup, feature cache) the way production traffic
    would. With a ``sample`` video its bytes seed every item (a unique
    suffix after the container payload keeps items distinct while still
    decodable); without one the items are tiny synthetic stubs — enough
    for stub-served drills and admission-plane tests."""
    from .utils.sinks import _write_bytes_atomic
    os.makedirs(corpus_dir, exist_ok=True)
    base = b""
    if sample:
        with open(sample, "rb") as f:
            base = f.read()
    out: Dict[str, str] = {}
    for spec in specs:
        for rank in range(spec["corpus"]["n_items"]):
            key = content_key(spec, rank)
            path = os.path.join(corpus_dir, f"{key}.mp4")
            if key not in out:
                data = base + b"\x00vft-corpus:" + key.encode() \
                    if base else b"vft-synth-corpus:" + key.encode()
                if not os.path.exists(path):
                    _write_bytes_atomic(path, data)
                out[key] = path
    return out


# -- the drill runner --------------------------------------------------------

def _pctl(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile; None on empty."""
    if not values:
        return None
    vs = sorted(values)
    idx = max(0, min(len(vs) - 1, math.ceil(q / 100.0 * len(vs)) - 1))
    return round(vs[idx], 4)


class DrillRunner:
    """One recorded drill: issue the offered schedule of one or more
    composed scenarios against a live gateway, then join every journal
    the stack already keeps into the ``_scenario.json`` verdict."""

    def __init__(self, specs: List[Dict[str, Any]], spool_dir: str,
                 base_url: str, *, corpus: Dict[str, str],
                 out_root: Optional[str] = None,
                 speedup: Optional[float] = None,
                 host_id: Optional[str] = None,
                 audit_root: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 drain_timeout_s: float = 60.0,
                 http_timeout_s: float = 30.0) -> None:
        if not specs:
            raise ValueError("need at least one scenario spec")
        self.specs = list(specs)
        self.spool_dir = str(spool_dir)
        self.base_url = base_url.rstrip("/")
        self.corpus = dict(corpus)
        self.out_root = str(out_root or spool_dir)
        self.speedup = float(
            speedup if speedup is not None
            else next((s["speedup"] for s in specs if s["speedup"]),
                      20.0 if specs[0]["clock"] == "virtual" else 1.0))
        self.host_id = host_id or f"lg-{socket.gethostname()}-{os.getpid()}"
        self.audit_root = str(audit_root or os.path.dirname(
            os.path.abspath(self.spool_dir)))
        self.cache_dir = cache_dir
        self.drain_timeout_s = float(drain_timeout_s)
        self.http_timeout_s = float(http_timeout_s)
        self.journal_path = os.path.join(self.out_root,
                                         journal_filename(self.host_id))
        self.registry = MetricsRegistry()
        #: loadgen id -> outcome {code, gw_id, tenant, scenario, t,
        #: timeout_s, attempts, error}
        self.outcomes: Dict[str, Dict[str, Any]] = {}
        self._api_key = {t: spec["tenants"][t]["key"]
                         for spec in specs for t in spec["tenants"]}
        self._uploaded: Dict[str, str] = {}

    # -- HTTP ----------------------------------------------------------------
    def _call(self, method: str, path: str, data: Optional[bytes],
              key: Optional[str]) -> Tuple[int, dict, Dict[str, str]]:
        req = urllib.request.Request(self.base_url + path, data=data,
                                     method=method)
        if key:
            req.add_header("X-API-Key", key)
        try:
            with urllib.request.urlopen(
                    req, timeout=self.http_timeout_s) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except ValueError:
                body = {}
            return e.code, body, dict(e.headers)

    def _slow_upload(self, data: bytes, name: str, key: str,
                     bps: float) -> Tuple[int, dict]:
        """A deliberately slow client: stream the body in small chunks
        paced to ``bps`` so the gateway's body read (its ``gateway.read``
        inject site) sees a trickling upload, not one recv."""
        import http.client
        from urllib.parse import urlparse
        u = urlparse(self.base_url)
        conn = http.client.HTTPConnection(u.hostname, u.port,
                                          timeout=self.http_timeout_s)
        try:
            conn.putrequest("POST", f"/v1/upload?name={name}")
            conn.putheader("X-API-Key", key)
            conn.putheader("Content-Length", str(len(data)))
            conn.endheaders()
            chunk = max(1, int(bps / 10))  # ~10 sends per second
            for i in range(0, len(data), chunk):
                conn.send(data[i:i + chunk])
                if i + chunk < len(data):
                    time.sleep(chunk / bps)
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def _ensure_ingested(self, ev: Dict[str, Any],
                         spec: Dict[str, Any]) -> List[str]:
        """Resolve the event's content keys to server-side paths —
        either the shared-filesystem corpus paths, or (``corpus.upload``
        scenarios) the content-addressed inbox paths after pushing the
        bytes through the real upload door, throttled for slow-client
        tenants. Re-uploading a hot item on every request is the point:
        the gateway answers with a dedup hit instead of duplicate
        bytes on disk."""
        if not spec["corpus"]["upload"]:
            return [self.corpus[k] for k in ev["videos"]]
        key = self._api_key[ev["tenant"]]
        paths = []
        for ck in ev["videos"]:
            with open(self.corpus[ck], "rb") as f:
                data = f.read()
            bps = ev.get("slow_bps")
            if bps:
                st, body = self._slow_upload(data, f"{ck}.mp4", key, bps)
            else:
                st, body, _ = self._call(
                    "POST", f"/v1/upload?name={ck}.mp4", data, key)
            if st in (200, 201) and body.get("path"):
                self._uploaded[ck] = body["path"]
            paths.append(self._uploaded.get(ck, self.corpus[ck]))
        return paths

    # -- the run -------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        from .utils import inject
        plans = [s["inject"] for s in self.specs if s.get("inject")]
        if len(plans) > 1:
            print("vft-loadgen: multiple inject plans; arming the first "
                  "only (one plan per process)", file=sys.stderr)
        # a fresh drill, a fresh record: drop both the journal and any
        # prior verdict (a stale _scenario.json would fail the audit's
        # artifact/journal consistency invariant against the new events)
        for stale in (self.journal_path,
                      os.path.join(self.out_root, SCENARIO_FILENAME)):
            try:
                os.unlink(stale)
            except OSError:
                pass
        os.makedirs(self.out_root, exist_ok=True)
        events = sorted(
            (ev for spec in self.specs for ev in offered_events(spec)),
            key=lambda e: (e["t"], e["scenario"], e["seq"]))
        inject.arm_for_run(plans[0] if plans else None)
        spec_of = {s["scenario"]: s for s in self.specs}
        t_start = time.monotonic()
        try:
            for ev in events:
                jsonl.append_jsonl(self.journal_path, ev)
                if ev["event"] != "request":
                    continue
                # pace the wall clock to the compressed virtual schedule
                lag = ev["t"] / self.speedup - (time.monotonic() - t_start)
                if lag > 0:
                    time.sleep(lag)
                self._issue(ev, spec_of[ev["scenario"]])
            self._drain()
        finally:
            inject.disarm()
        report = self.build_report()
        jsonl.write_json_atomic(
            os.path.join(self.out_root, SCENARIO_FILENAME), report)
        return report

    def _issue(self, ev: Dict[str, Any], spec: Dict[str, Any]) -> None:
        tenant = ev["tenant"]
        out: Dict[str, Any] = {"code": None, "gw_id": None,
                               "tenant": tenant,
                               "scenario": ev["scenario"], "t": ev["t"],
                               "timeout_s": ev["timeout_s"],
                               "attempts": 0, "error": None}
        self.outcomes[ev["id"]] = out
        self.registry.counter("vft_loadgen_offered_total",
                              tenant=tenant).inc()
        try:
            paths = self._ensure_ingested(ev, spec)
        except (OSError, ValueError, Exception) as e:  # noqa: BLE001 —
            # ingestion faults (incl. injected slow-client kills) must
            # surface as drill errors, never kill the drill
            out["error"] = f"upload: {type(e).__name__}: {e}"
            return
        body: Dict[str, Any] = {"video_paths": paths}
        if ev["timeout_s"] is not None:
            body["timeout_s"] = ev["timeout_s"] / self.speedup
        data = json.dumps(body).encode()
        key = self._api_key[tenant]
        for attempt in range(1 + spec["retry_max"]):
            out["attempts"] = attempt + 1
            try:
                st, resp, _ = self._call("POST", "/v1/extract", data, key)
            except (OSError, ValueError) as e:
                out["code"], out["error"] = 0, f"{type(e).__name__}: {e}"
                break
            out["code"] = st
            if st == 202:
                out["gw_id"] = resp.get("id")
                break
            if st == 429 and attempt < spec["retry_max"]:
                # an honest Retry-After converges; cap the wall sleep so
                # a lying one cannot stall the drill
                time.sleep(min(float(resp.get("retry_after_s") or 1.0),
                               5.0))
                continue
            break
        name = {202: "vft_loadgen_admitted_total",
                429: "vft_loadgen_rejected_total",
                503: "vft_loadgen_shed_total"}.get(out["code"])
        if name:
            self.registry.counter(name, tenant=tenant).inc()

    def _drain(self) -> None:
        """Wait (wall-bounded) until every admitted request reached a
        terminal record — ``done/`` or ``expired/``; the gateway sweep
        expires the edge-queued stragglers. An incomplete drain is not
        hidden: the missing terminals fail the audit gate."""
        pending = {o["gw_id"] for o in self.outcomes.values()
                   if o["gw_id"]}
        deadline = time.monotonic() + self.drain_timeout_s
        while pending and time.monotonic() < deadline:
            pending = {rid for rid in pending
                       if serve.read_terminal(self.spool_dir, rid) is None}
            if pending:
                time.sleep(0.05)

    # -- the exit join -------------------------------------------------------
    def build_report(self, now: Optional[float] = None) -> Dict[str, Any]:
        from .audit import audit_run
        from .telemetry.alerts import ALERTS_FILENAME
        from .telemetry.history import read_history
        duration = max(s["duration_s"] for s in self.specs)
        slo_s = next((s["slo_s"] for s in self.specs
                      if s["slo_s"] is not None), None)
        offered_by_sc: Dict[str, int] = {}
        for rec in jsonl.read_jsonl(self.journal_path):
            if rec.get("event") == "request":
                offered_by_sc[rec["scenario"]] = \
                    offered_by_sc.get(rec["scenario"], 0) + 1

        tenants: Dict[str, Dict[str, Any]] = {
            t: {"offered": 0, "admitted": 0, "completed": 0,
                "expired": 0, "rejected": 0, "shed": 0, "errors": 0,
                "violations": 0, "attainment_pct": None}
            for t in self._api_key}
        waits: List[float] = []
        services: List[float] = []
        n_windows = max(s["curve_windows"] for s in self.specs)
        win_w = duration / n_windows
        windows: List[Dict[str, Any]] = [
            {"t0": round(i * win_w, 3), "t1": round((i + 1) * win_w, 3),
             "tenants": {}} for i in range(n_windows)]

        def wslot(t: float) -> Dict[str, Any]:
            return windows[min(n_windows - 1, int(t / win_w))]["tenants"]

        for lg_id, out in self.outcomes.items():
            tb = tenants[out["tenant"]]
            wb = wslot(out["t"]).setdefault(
                out["tenant"], {"offered": 0, "admitted": 0,
                                "completed": 0, "violations": 0,
                                "attainment_pct": None})
            tb["offered"] += 1
            wb["offered"] += 1
            if out["error"] is not None or out["code"] == 0:
                tb["errors"] += 1
                continue
            if out["code"] == 429:
                tb["rejected"] += 1
                continue
            if out["code"] == 503:
                tb["shed"] += 1
                continue
            if out["code"] != 202:
                tb["errors"] += 1
                continue
            tb["admitted"] += 1
            wb["admitted"] += 1
            term = serve.read_terminal(self.spool_dir, out["gw_id"])
            if term is None:
                # never reached a terminal inside the drain window —
                # an audit-visible hole, counted as a violation here too
                tb["violations"] += 1
                wb["violations"] += 1
                continue
            if term.get("status") == "deadline_exceeded":
                tb["expired"] += 1
                tb["violations"] += 1
                wb["violations"] += 1
                self.registry.counter("vft_loadgen_expired_total",
                                      tenant=out["tenant"]).inc()
                continue
            tb["completed"] += 1
            wb["completed"] += 1
            self.registry.counter("vft_loadgen_completed_total",
                                  tenant=out["tenant"]).inc()
            # measured wall durations scale back into virtual seconds
            wait_v = float(term.get("wait_s") or 0.0) * self.speedup
            svc_v = float(term.get("latency_s") or 0.0) * self.speedup
            waits.append(wait_v)
            services.append(svc_v)
            if slo_s is not None and wait_v + svc_v > slo_s:
                tb["violations"] += 1
                wb["violations"] += 1

        for tb in tenants.values():
            answered = tb["admitted"]
            if answered:
                tb["attainment_pct"] = round(
                    100.0 * (answered - tb["violations"]) / answered, 2)
        for w in windows:
            for wb in w["tenants"].values():
                if wb["admitted"]:
                    wb["attainment_pct"] = round(
                        100.0 * (wb["admitted"] - wb["violations"])
                        / wb["admitted"], 2)

        history = None
        try:
            by_host = read_history(self.spool_dir)
        except Exception:
            by_host = {}
        samples = [s for host_samples in by_host.values()
                   for s in host_samples
                   if isinstance(s.get("tenants"), dict)]
        samples.sort(key=lambda s: float(s.get("time") or 0.0))
        if samples:
            series: Dict[str, List[Dict[str, Any]]] = {}
            for s in samples:
                for t, v in s["tenants"].items():
                    series.setdefault(t, []).append(
                        {"time": s.get("time"),
                         "attainment_pct": v.get("attainment_pct")})
            history = {"ticks": len(samples), "tenants": series}

        alerts = {"page": 0, "ticket": 0}
        for rec in jsonl.read_jsonl(
                os.path.join(self.spool_dir, ALERTS_FILENAME)):
            if rec.get("state") == "firing" \
                    and rec.get("severity") in alerts:
                alerts[rec.get("severity")] += 1

        try:
            ok, violations, _notes = audit_run(
                self.audit_root, cache_dir=self.cache_dir,
                expect_complete=True)
            audit = {"pass": bool(ok), "violations": len(violations)}
        except Exception as e:
            audit = {"pass": False, "violations": -1,
                     "error": f"{type(e).__name__}: {e}"}

        totals = {k: sum(tb[k] for tb in tenants.values())
                  for k in ("offered", "admitted", "completed", "expired",
                            "rejected", "shed", "errors")}
        objectives = []
        all_met = True
        for spec in self.specs:
            for obj in spec["objectives"]:
                actual, met = self._eval_objective(obj, tenants, totals)
                objectives.append({**obj, "scenario": spec["scenario"],
                                   "actual": actual, "met": met})
                all_met = all_met and met
        verdict = "PASS" if (audit["pass"] and all_met) else "FAIL"

        report = {
            "schema": SCENARIO_SCHEMA,
            "time": round(now if now is not None else time.time(), 3),
            "scenario": "+".join(s["scenario"] for s in self.specs),
            "scenarios": [{"name": s["scenario"], "seed": s["seed"],
                           "spec_sha": s["spec_sha"],
                           "offered": offered_by_sc.get(
                               s["scenario"], 0)}
                          for s in self.specs],
            "clock": self.specs[0]["clock"],
            "speedup": self.speedup,
            "duration_s": duration,
            "slo_s": slo_s,
            "host_id": self.host_id,
            "journal": os.path.basename(self.journal_path),
            **totals,
            "tenants": tenants,
            "latency": {"unit": "virtual_s",
                        "wait": {"p50": _pctl(waits, 50),
                                 "p95": _pctl(waits, 95),
                                 "p99": _pctl(waits, 99)},
                        "service": {"p50": _pctl(services, 50),
                                    "p95": _pctl(services, 95),
                                    "p99": _pctl(services, 99)}},
            "curve": windows,
            "history": history,
            "alerts": alerts,
            "audit": audit,
            "objectives": objectives,
            "verdict": verdict,
        }
        return report

    @staticmethod
    def _eval_objective(obj: Dict[str, Any],
                        tenants: Dict[str, Dict[str, Any]],
                        totals: Dict[str, int]
                        ) -> Tuple[Optional[float], bool]:
        scope = (tenants.get(str(obj["tenant"]))
                 if obj.get("tenant") is not None else totals)
        if scope is None:
            return None, False

        def pct(num_key: str) -> Optional[float]:
            off = scope.get("offered") or 0
            if not off:
                return None
            return round(100.0 * (scope.get(num_key) or 0) / off, 2)

        met = True
        actual: Optional[float] = None
        if "min_attainment_pct" in obj:
            actual = (tenants.get(str(obj.get("tenant")), {})
                      .get("attainment_pct")
                      if obj.get("tenant") is not None else None)
            if actual is None and obj.get("tenant") is None:
                # fleet-wide: admitted-weighted over every tenant
                adm = sum(tb["admitted"] for tb in tenants.values())
                vio = sum(tb["violations"] for tb in tenants.values())
                actual = (round(100.0 * (adm - vio) / adm, 2)
                          if adm else None)
            met = actual is not None \
                and actual >= float(obj["min_attainment_pct"])
        elif "min_admitted_pct" in obj:
            actual = pct("admitted")
            met = actual is not None \
                and actual >= float(obj["min_admitted_pct"])
        elif "max_shed_pct" in obj:
            actual = pct("shed")
            met = actual is not None \
                and actual <= float(obj["max_shed_pct"])
        elif "max_rejected_pct" in obj:
            actual = pct("rejected")
            met = actual is not None \
                and actual <= float(obj["max_rejected_pct"])
        elif "max_expired_pct" in obj:
            actual = pct("expired")
            met = actual is not None \
                and actual <= float(obj["max_expired_pct"])
        elif "min_rejected" in obj:
            actual = float(scope.get("rejected") or 0)
            met = actual >= float(obj["min_rejected"])
        elif "min_expired" in obj:
            actual = float(scope.get("expired") or 0)
            met = actual >= float(obj["min_expired"])
        elif "min_completed" in obj:
            actual = float(scope.get("completed") or 0)
            met = actual >= float(obj["min_completed"])
        else:
            met = False
        return actual, met


# -- CLI ---------------------------------------------------------------------

def loadgen_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch loadgen",
        description="Seeded, replayable traffic drills against the "
                    "gateway front door; each run publishes a "
                    "_scenario.json verdict with the SLO attainment "
                    "curve")
    ap.add_argument("scenarios", nargs="+",
                    help="scenario YAML path(s); several compose onto "
                         "one timeline with independent streams")
    ap.add_argument("--spool", required=True,
                    help="the gateway/serve spool dir (journals, "
                         "terminals and the verdict artifact land here)")
    ap.add_argument("--base-url", default=None,
                    help="gateway base URL, e.g. http://127.0.0.1:8080 "
                         "(required unless --dry-run/--emit-tenants)")
    ap.add_argument("--corpus", default=None,
                    help="corpus dir (default {spool}/loadgen_corpus)")
    ap.add_argument("--sample", default=None,
                    help="seed video whose bytes back the synthesized "
                         "corpus items")
    ap.add_argument("--speedup", type=float, default=None,
                    help="override the scenario clock compression")
    ap.add_argument("--out", default=None,
                    help="artifact dir (default: the spool)")
    ap.add_argument("--audit-root", default=None,
                    help="tree the audit verifies (default: the "
                         "spool's parent)")
    ap.add_argument("--cache-dir", default=None,
                    help="feature-cache dir for the audit gate")
    ap.add_argument("--host-id", default=None,
                    help="journal identity (default lg-{host}-{pid})")
    ap.add_argument("--drain-timeout-s", type=float, default=60.0,
                    help="wall bound on waiting for terminals at exit")
    ap.add_argument("--dry-run", action="store_true",
                    help="write the deterministic offered journal only "
                         "— no HTTP, no verdict")
    ap.add_argument("--emit-tenants", metavar="PATH", default=None,
                    help="write the speedup-scaled gateway tenants.yml "
                         "for these scenarios and exit")
    args = ap.parse_args(argv)

    try:
        specs = [load_scenario(p) for p in args.scenarios]
    except (OSError, ValueError) as e:
        print(f"vft-loadgen: {e}", file=sys.stderr)
        return 2
    names = [s["scenario"] for s in specs]
    if len(set(names)) != len(names):
        print("vft-loadgen: composed scenarios must have distinct "
              "names", file=sys.stderr)
        return 2
    speedup = float(
        args.speedup if args.speedup is not None
        else next((s["speedup"] for s in specs if s["speedup"]),
                  20.0 if specs[0]["clock"] == "virtual" else 1.0))

    if args.emit_tenants:
        write_tenant_table(specs, args.emit_tenants, speedup)
        print(f"vft-loadgen: wrote {args.emit_tenants} "
              f"(rate_rps x{speedup:g})")
        return 0

    os.makedirs(args.spool, exist_ok=True)
    if args.dry_run:
        host = args.host_id or f"lg-{socket.gethostname()}-{os.getpid()}"
        out_root = args.out or args.spool
        os.makedirs(out_root, exist_ok=True)
        jpath = os.path.join(out_root, journal_filename(host))
        try:
            os.unlink(jpath)
        except OSError:
            pass
        events = sorted(
            (ev for spec in specs for ev in offered_events(spec)),
            key=lambda e: (e["t"], e["scenario"], e["seq"]))
        for ev in events:
            jsonl.append_jsonl(jpath, ev)
        n = sum(1 for e in events if e["event"] == "request")
        print(f"vft-loadgen: dry run — {n} offered request(s) "
              f"journaled to {jpath}")
        return 0

    if not args.base_url:
        print("vft-loadgen: --base-url is required (or --dry-run / "
              "--emit-tenants)", file=sys.stderr)
        return 2
    corpus_dir = args.corpus or os.path.join(args.spool, "loadgen_corpus")
    corpus = synthesize_corpus(corpus_dir, specs, sample=args.sample)
    runner = DrillRunner(
        specs, args.spool, args.base_url, corpus=corpus,
        out_root=args.out, speedup=speedup, host_id=args.host_id,
        audit_root=args.audit_root, cache_dir=args.cache_dir,
        drain_timeout_s=args.drain_timeout_s)
    report = runner.run()
    t = report["tenants"]
    for name in sorted(t):
        tb = t[name]
        att = (f"{tb['attainment_pct']}%"
               if tb["attainment_pct"] is not None else "n/a")
        print(f"vft-loadgen: {name}: offered={tb['offered']} "
              f"admitted={tb['admitted']} completed={tb['completed']} "
              f"expired={tb['expired']} 429={tb['rejected']} "
              f"shed={tb['shed']} attainment={att}")
    print(f"vft-loadgen: {report['scenario']}: {report['verdict']} "
          f"(audit={'PASS' if report['audit']['pass'] else 'FAIL'}, "
          f"{sum(1 for o in report['objectives'] if o['met'])}/"
          f"{len(report['objectives'])} objective(s) met) -> "
          f"{os.path.join(runner.out_root, SCENARIO_FILENAME)}")
    return 0 if report["verdict"] == "PASS" else 1


def main() -> int:
    return loadgen_main(sys.argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
