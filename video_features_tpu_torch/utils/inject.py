"""Deterministic fault injection (port of
``video_features_tpu/utils/inject.py``).

A run armed with a plan fires the same faults at the same named sites in the
same order every time, so a failing seed replays exactly from its plan::

    inject="seed=7;sink.fsync=enospc@n1;decode.read=eio@p0.05"

``seed=<int>`` seeds every probabilistic trigger, one independent stream per
site and fault (``random.Random(f"{seed}:{site}:{kind}")``, as in the JAX
package, so one seed fires at the same hits in both). Each rule is
``<site>=<fault>@<trigger>``:

  - faults: ``eio``, ``enospc``, ``edquot``, ``erofs`` raise ``OSError``
    with that errno; ``error`` raises ``RuntimeError``; ``torn``
    (``sink.tmp_write``: a truncated write, then EIO) and ``drop``
    (``sink.rename``: the rename is lost) are applied by their call site;
    ``kill`` SIGKILLs the process;
  - triggers: ``n<int>`` (the Nth hit of the site, 1-based), ``first``
    (``n1``), ``every<int>``, ``after<int>``, ``p<float>`` (each hit with
    probability p from the site's seeded stream).

The grammar names every site of the JAX package (:data:`SITES`). The port
hosts ``decode.read`` (``utils/io.py _FrameStream.read``, every decode
source, spawned decode workers included), ``sink.tmp_write`` /
``sink.fsync`` / ``sink.rename`` (``utils/sinks.py _write_bytes_atomic``),
``worker.kill`` (``utils/sinks.py safe_extract``, once per attempt) and
``cache.lookup`` (``torn``: the entry is truncated before it is read) /
``cache.store`` (``cache.py FeatureCache``) and ``heartbeat.tick``
(``telemetry/heartbeat.py``, each tick of a ``telemetry=true`` run;
``freeze`` skips the tick, a raise-kind fault is counted as a tick error). A
plan naming a site whose plane is not ported (:data:`UNPORTED_SITES`) raises
``NotImplementedError`` naming its ``ROADMAP.md`` Queue 1 item, so no rule
is ever left silently dead.

Arming: the CLI arms the ``inject=`` plan at run start and disarms it in its
``finally``; ``VFT_INJECT`` overrides the key and also arms a spawned decode
worker when this module is imported there (such a child never runs the CLI).
Off, a site costs one module-global read.
"""
from __future__ import annotations

import errno
import os
import random
import signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

#: every named injection site of the JAX package
SITES = (
    "decode.read", "sink.tmp_write", "sink.fsync", "sink.rename",
    "cache.store", "cache.lookup", "queue.claim", "queue.steal_staging",
    "spool.claim", "spool.respond", "gateway.read", "gateway.spool_submit",
    "heartbeat.tick", "worker.kill", "gc.evict", "gc.sweep",
)

#: sites whose plane the port does not run yet -> the ROADMAP.md Queue 1
#: item that ports it
UNPORTED_SITES = {
    "queue.claim": 8, "queue.steal_staging": 8, "spool.claim": 8,
    "spool.respond": 8, "gateway.read": 8, "gateway.spool_submit": 8,
    "gc.evict": 8, "gc.sweep": 8,
}

#: raise-kind faults -> the errno they raise with (None = RuntimeError)
_RAISE_ERRNO = {
    "eio": errno.EIO,
    "enospc": errno.ENOSPC,
    "edquot": errno.EDQUOT,
    "erofs": errno.EROFS,
    "error": None,
}

#: behavioral faults: ``fire`` returns them for the call site to apply
_BEHAVIORAL = ("torn", "drop", "skew", "freeze", "stall")

FAULT_KINDS = tuple(_RAISE_ERRNO) + _BEHAVIORAL + ("kill",)

#: where each behavioral kind applies (checked when the plan is parsed)
_BEHAVIORAL_SITES = {
    "torn": ("sink.tmp_write", "cache.lookup", "gateway.read"),
    "drop": ("sink.rename", "queue.steal_staging", "gateway.spool_submit",
             "spool.respond", "gc.evict"),
    "skew": ("queue.claim",),
    "freeze": ("heartbeat.tick",),
    "stall": ("gateway.read", "gc.sweep"),
}


class Fault:
    """One fired behavioral fault, returned to its call site."""

    __slots__ = ("site", "kind", "hit")

    def __init__(self, site: str, kind: str, hit: int) -> None:
        self.site = site
        self.kind = kind
        self.hit = hit

    def __repr__(self) -> str:
        return f"Fault({self.site}={self.kind}@hit{self.hit})"


class _Rule:
    __slots__ = ("site", "kind", "trigger", "value", "rng")

    def __init__(self, site: str, kind: str, trigger: str, value: float,
                 seed: int) -> None:
        self.site = site
        self.kind = kind
        self.trigger = trigger
        self.value = value
        # one stream per site and fault: another rule never shifts its draws
        self.rng = random.Random(f"{seed}:{site}:{kind}")

    def should_fire(self, hit: int) -> bool:
        if self.trigger == "n":
            return hit == int(self.value)
        if self.trigger == "every":
            return hit % int(self.value) == 0
        if self.trigger == "after":
            return hit > int(self.value)
        return self.rng.random() < self.value  # "p": one draw per hit


class InjectionPlan:
    """A parsed plan: per-site hit counters and fire decisions, under a
    lock (sites are hit from decode and extraction threads at once)."""

    def __init__(self, spec: str, seed: int,
                 rules: Dict[str, _Rule]) -> None:
        self.spec = spec
        self.seed = seed
        self.rules = rules
        self.hits: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def check(self, site: str, ctx: Dict[str, Any]) -> Optional[Fault]:
        rule = self.rules.get(site)
        if rule is None:
            return None
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            if not rule.should_fire(hit):
                return None
            self.fired[site] = self.fired.get(site, 0) + 1
        return self._apply(rule, site, hit, ctx)

    def _apply(self, rule: _Rule, site: str, hit: int,
               ctx: Dict[str, Any]) -> Optional[Fault]:
        detail = " ".join(f"{k}={v}" for k, v in ctx.items() if v is not None)
        print(f"INJECT: {site}={rule.kind} fired (hit {hit}, seed "
              f"{self.seed}{', ' + detail if detail else ''})")
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(30)  # SIGKILL is not synchronous; never fall through
        if rule.kind in _RAISE_ERRNO:
            eno = _RAISE_ERRNO[rule.kind]
            if eno is None:
                raise RuntimeError(
                    f"injected fault at {site} (hit {hit}, seed {self.seed})")
            raise OSError(eno, f"injected {rule.kind.upper()} at {site} "
                               f"(hit {hit}, seed {self.seed})")
        return Fault(site, rule.kind, hit)

    def summary(self) -> str:
        with self._lock:
            fired = dict(self.fired)
            hits = dict(self.hits)
        parts = [f"{s}:{fired.get(s, 0)}/{hits[s]}" for s in sorted(hits)]
        return (f"inject: seed={self.seed} fired/hits "
                f"{{{', '.join(parts) or 'no sites hit'}}} "
                f"(plan {self.spec!r})")


def parse_plan(spec: str) -> InjectionPlan:
    """Parse and validate a plan string: ``ValueError`` naming the clause
    for a malformed one (as the JAX package), ``NotImplementedError`` for a
    site of an unported plane."""
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"inject={spec!r}: expected a non-empty plan "
                         "string like 'seed=1;sink.fsync=enospc@n1'")
    seed = 0
    rules: Dict[str, _Rule] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(f"inject: clause {clause!r} is not key=value")
        key, val = (p.strip() for p in clause.split("=", 1))
        if key == "seed":
            try:
                seed = int(val)
            except ValueError:
                raise ValueError(f"inject: seed={val!r} is not an int")
            continue
        if key not in SITES:
            raise ValueError(f"inject: unknown site {key!r} "
                             f"(sites: {', '.join(SITES)})")
        kind, trigger, value = _parse_fault(key, val)
        if key in UNPORTED_SITES:
            raise NotImplementedError(
                f"inject: site {key!r} is not ported yet (its plane is "
                f"ROADMAP.md Queue 1 #{UNPORTED_SITES[key]}); the port "
                "hosts " + ", ".join(s for s in SITES
                                     if s not in UNPORTED_SITES))
        rules[key] = _Rule(key, kind, trigger, value, seed)
    # rebuild with the final seed, so clause order never matters
    rules = {s: _Rule(s, r.kind, r.trigger, r.value, seed)
             for s, r in rules.items()}
    if not rules:
        raise ValueError(f"inject={spec!r}: plan has no site rules")
    return InjectionPlan(spec, seed, rules)


def _parse_fault(site: str, val: str) -> Tuple[str, str, float]:
    kind, sep, trig = val.partition("@")
    kind = kind.strip()
    if kind not in FAULT_KINDS:
        raise ValueError(f"inject: {site}: unknown fault {kind!r} "
                         f"(faults: {', '.join(FAULT_KINDS)})")
    if kind in _BEHAVIORAL and site not in _BEHAVIORAL_SITES[kind]:
        raise ValueError(
            f"inject: fault {kind!r} only applies at "
            f"{'/'.join(_BEHAVIORAL_SITES[kind])}, not {site!r}")
    trig = (trig.strip() or "first") if sep else "first"
    if trig == "first":
        return kind, "n", 1.0
    for prefix in ("every", "after"):  # before 'n'/'p': longest first
        if trig.startswith(prefix):
            try:
                n = int(trig[len(prefix):])
            except ValueError:
                n = 0
            if n < 1:
                raise ValueError(f"inject: {site}: trigger {trig!r} needs "
                                 f"a positive int after '{prefix}'")
            return kind, prefix, float(n)
    if trig.startswith("n"):
        try:
            n = int(trig[1:])
        except ValueError:
            n = 0
        if n < 1:
            raise ValueError(f"inject: {site}: trigger {trig!r} needs a "
                             "positive int after 'n'")
        return kind, "n", float(n)
    if trig.startswith("p"):
        try:
            p = float(trig[1:])
        except ValueError:
            p = -1.0
        if not 0.0 < p <= 1.0:
            raise ValueError(f"inject: {site}: trigger {trig!r} needs a "
                             "probability in (0, 1] after 'p'")
        return kind, "p", p
    raise ValueError(f"inject: {site}: unknown trigger {trig!r} "
                     "(use n<int>, first, every<int>, after<int>, p<float>)")


# -- the armed plan (one module global; None = injection off) ----------------

_active: Optional[InjectionPlan] = None


def active() -> Optional[InjectionPlan]:
    """The armed plan, if any (hot call sites hold it in a local)."""
    return _active


def fire(site: str, **ctx: Any) -> Optional[Fault]:
    """The injection hook. Off: one global read, ``None``. Armed: count the
    hit; when the site's trigger matches, raise-kind faults raise here,
    ``kill`` SIGKILLs the process, and behavioral faults are returned for
    the call site to apply."""
    plan = _active
    if plan is None:
        return None
    return plan.check(site, ctx)


def arm_for_run(config_spec: Optional[str]) -> Optional[InjectionPlan]:
    """Arm the plan of one CLI run: ``VFT_INJECT`` wins over the
    ``inject=`` key. Returns the armed plan, or ``None``, which also
    disarms a plan an earlier in-process run left behind."""
    global _active
    spec = os.environ.get("VFT_INJECT") or config_spec
    _active = parse_plan(spec) if spec else None
    return _active


def disarm() -> None:
    """Back to the import-time state: the ``VFT_INJECT`` plan if set (a
    spawned worker stays armed for its whole life), else off."""
    global _active
    spec = os.environ.get("VFT_INJECT")
    _active = parse_plan(spec) if spec else None


# a spawned decode worker with VFT_INJECT in its environment arms here: it
# never runs the CLI prologue that calls arm_for_run
if os.environ.get("VFT_INJECT"):
    _active = parse_plan(os.environ["VFT_INJECT"])
