"""The port's storage lifecycle plane (``video_features_tpu_torch/gc.py``)
against the JAX package's ``video_features_tpu/gc.py``.

- The scenarios of the JAX ``tests/test_gc.py`` (usage, each planner's
  safety rule, quota pressure), each built once with numpy-seeded bytes and
  fixed mtimes: the port's ``plan`` and JAX's give the same deletions
  (plane, path under the tree, bytes, directory or not, reason) and their
  ``usage`` documents are equal but for the walk's time stamp;
- ``plan_compile`` with both packages' environment fingerprints pinned to
  one value; the port's own rules: the attached entry and the build
  directory are never planned, the fingerprint is taken once a sweep and
  never by ``usage``;
- the journal: the port's records equal JAX's field for field, apart from
  the host and the time;
- the gc chaos matrix (JAX ``tests/test_chaos.py`` seeds 40 and 41): the
  ``gc.evict`` and ``gc.sweep`` sites fire, a journaled remnant audits as a
  note in both packages' audits, and a second sweep converges; a sweep
  SIGKILLed between a journal append and its unlink (``gc.evict=kill``)
  audits clean and converges;
- the monitor: walks cached on the interval, gauges published, its section
  equal to JAX's; ``gc=true`` on a CLI run publishes the heartbeat ``gc``
  section, the ``vft_gc_*`` metrics and the history samples that
  ``disk_pressure`` fires on; ``gc=false`` registers nothing;
- the ``gc`` subcommand: one-shot ``--json``, ``--watch``, and the
  rejection of bad flags.
"""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu import gc as jgc
from video_features_tpu.audit import audit_run as jaudit_run
from video_features_tpu.telemetry.jsonl import read_jsonl
from video_features_tpu_torch import gc as tgc
from video_features_tpu_torch.audit import audit_run as taudit_run
from video_features_tpu_torch.telemetry.jsonl import append_jsonl

REPO = Path(__file__).resolve().parents[1]
#: the planners' clock: every mtime below is NOW minus an age
NOW = 1_700_000_000.0
#: the environment fingerprint both packages see in these tests
FP = "ab" * 32
#: every plane's retention, so that each planner runs in every scenario
RETAIN = {k: 1000 for k in tgc._RETENTION_KEYS}


@pytest.fixture(autouse=True)
def pinned_fingerprint(monkeypatch):
    """Both packages' compile stores see one host fingerprint (no
    ``nvcc``/``nvidia-smi`` and no XLA backend is asked), and no entry is
    attached in this process."""
    from video_features_tpu import compile_cache as jcc
    from video_features_tpu_torch import compile_cache as tcc
    monkeypatch.setattr(jcc, "env_fingerprint", lambda: ({}, FP))
    monkeypatch.setattr(tcc, "env_fingerprint", lambda: ({}, FP))
    monkeypatch.setattr(jcc, "_active", None)
    tcc.detach_for_tests()
    yield
    tcc.detach_for_tests()


class Tree:
    """A scenario tree under ``base``: files of seeded bytes with mtimes
    fixed relative to :data:`NOW`."""

    def __init__(self, base: Path, seed: int) -> None:
        self.base = base
        self.rng = np.random.default_rng(seed)
        self.root = base / "root"
        self.cache = base / "cache"
        self.compile = base / "compile"
        self.root.mkdir(parents=True)

    def file(self, rel: str, nbytes: int = 16, *, age_s: float = 0.0,
             text=None) -> Path:
        p = self.base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if text is not None:
            p.write_text(json.dumps(text) if isinstance(text, dict)
                         else text)
        else:
            p.write_bytes(self.rng.integers(0, 256, nbytes,
                                            dtype=np.uint8).tobytes())
        self.age(p, age_s)
        return p

    @staticmethod
    def age(p: Path, age_s: float) -> None:
        os.utime(p, (NOW - age_s, NOW - age_s))

    def kw(self) -> dict:
        return dict(cache_dir=str(self.cache),
                    compile_dir=str(self.compile))


def _usage_tree(t: Tree) -> dict:
    t.file("root/done/r1.json", 100)
    t.file("root/expired/r2.json", 50)
    t.file("root/inbox/blobA", 300)
    t.file("root/_incidents/b1/hb.json", 40)
    t.file("root/_queue/quarantined/q.json", 20)
    t.file("root/_queue/.staging/s.json", 10)
    t.file("root/_telemetry.jsonl", 64)
    t.file("cache/ab/abcd.pkl", 500)
    gw = t.root / "_gateway_h1.jsonl"
    append_jsonl(gw, {"event": "upload", "tenant": "acme",
                      "sha256": "aa", "bytes": 300})
    append_jsonl(gw, {"event": "upload", "tenant": "acme",
                      "sha256": "aa", "bytes": 300, "dedup": True})
    append_jsonl(gw, {"event": "accepted", "tenant": "acme", "id": "r1"})
    return {}


def _cache_lru(t: Tree) -> dict:
    for i, age in enumerate((5000.0, 3000.0, 10.0)):
        t.file(f"cache/{i:02x}/{i:02x}beef.pkl", 100, age_s=age)
    # 150 bytes over the quota: the two coldest go, the hot one stays
    return {"gc_quota_gb": 150e-9}


def _cache_retention(t: Tree) -> dict:
    t.file("cache/aa/aaold.pkl", 10, age_s=5000.0)
    t.file("cache/bb/bbnew.pkl", 10, age_s=10.0)
    return dict(RETAIN)


def _spool_claimable(t: Tree) -> dict:
    t.file("root/done/r1.json", 10, age_s=5000.0)     # claimable
    t.file("root/done/r2.json", 10, age_s=5000.0)     # claimed below
    t.file("root/done/r4.json", 10, age_s=5000.0)     # expirable
    t.file("root/expired/r3.json", 10, age_s=10.0)    # too young
    t.file("root/requests/r1.json", text={"id": "r1"})
    t.file("root/claimed/hostX/r2.json", text={"id": "r2"})
    return dict(RETAIN)


def _inbox_referenced(t: Tree) -> dict:
    t.file("root/inbox/blobA", 10, age_s=5000.0)
    t.file("root/inbox/blobB", 10, age_s=5000.0)
    t.file("root/requests/r1.json", text={
        "id": "r1", "video_paths": [str(t.root / "inbox" / "blobA")]})
    return dict(RETAIN)


def _incidents_pinned(t: Tree) -> dict:
    t.file("root/_incidents/keep/hb.json", 10)
    t.file("root/_incidents/keep/pinned", 0)
    t.file("root/_incidents/drop/hb.json", 10)
    for b in ("keep", "drop"):
        t.age(t.root / "_incidents" / b, 5000.0)
    return dict(RETAIN)


def _staging_done(t: Tree) -> dict:
    t.file("root/_queue/.staging/a.json", text={"id": "it-1"})
    t.file("root/_queue/.staging/b.json", text={"id": "it-2"})
    for fn in ("a.json", "b.json"):
        t.age(t.root / "_queue" / ".staging" / fn, 5000.0)
    t.file("root/_queue/done/it-1.json", text={"id": "it-1",
                                               "status": "done"})
    return dict(RETAIN)


def _quarantine_age(t: Tree) -> dict:
    t.file("root/_queue/quarantined/old.json", 10, age_s=5000.0)
    t.file("root/_queue/quarantined/new.json", 10, age_s=10.0)
    return dict(RETAIN)


def _quota_only_cache(t: Tree) -> dict:
    t.file("cache/aa/aadead.pkl", 4000, age_s=100.0)
    t.file("root/done/r1.json", 4000, age_s=100.0)
    t.file("root/inbox/blob", 4000, age_s=100.0)
    return {"gc_quota_gb": 1e-6}


def _every_plane(t: Tree) -> dict:
    """All of the above at once, with a quota over the lot."""
    for build in (_usage_tree, _cache_lru, _spool_claimable,
                  _inbox_referenced, _incidents_pinned, _staging_done):
        build(t)
    t.file("root/_queue/quarantined/old.json", 10, age_s=5000.0)
    return dict(RETAIN, gc_quota_gb=1e-6)


SCENARIOS = {
    "usage": _usage_tree, "cache_lru": _cache_lru,
    "cache_retention": _cache_retention,
    "spool_claimable": _spool_claimable,
    "inbox_referenced": _inbox_referenced,
    "incidents_pinned": _incidents_pinned, "staging_done": _staging_done,
    "quarantine_age": _quarantine_age, "quota_only_cache": _quota_only_cache,
    "every_plane": _every_plane,
}


def _deletions(dels, base: Path):
    return [(d.plane, os.path.relpath(d.path, base), d.bytes, d.is_dir,
             d.reason) for d in dels]


def _usage(mod, t: Tree) -> dict:
    use = mod.usage(str(t.root), **t.kw())
    assert abs(use.pop("time") - time.time()) < 60
    return use


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plan_and_usage_equal_jax(name, tmp_path):
    t = Tree(tmp_path, seed=sorted(SCENARIOS).index(name))
    args = SCENARIOS[name](t)
    tgc.validate_gc_args(args)
    jgc.validate_gc_args(args)
    port = tgc.plan(str(t.root), tgc.GcConfig.from_args(args), now=NOW,
                    **t.kw())
    jax = jgc.plan(str(t.root), jgc.GcConfig.from_args(args), now=NOW,
                   **t.kw())
    assert _deletions(port, tmp_path) == _deletions(jax, tmp_path)
    assert _usage(tgc, t) == _usage(jgc, t)
    if name != "usage":
        assert port, "the scenario plans no deletion"


def test_scenarios_plan_what_the_jax_tests_expect(tmp_path):
    """The safety rules on the scenarios, as JAX ``tests/test_gc.py``
    states them."""
    want = {
        "cache_lru": ["00beef.pkl", "01beef.pkl"],
        "cache_retention": ["aaold.pkl"],
        "spool_claimable": ["r4.json"],
        "inbox_referenced": ["blobB"],
        "incidents_pinned": ["drop"],
        "staging_done": ["a.json"],
        "quarantine_age": ["old.json"],
        "quota_only_cache": ["aadead.pkl"],
    }
    for i, (name, names) in enumerate(sorted(want.items())):
        t = Tree(tmp_path / name, seed=i)
        args = SCENARIOS[name](t)
        dels = tgc.plan(str(t.root), tgc.GcConfig.from_args(args), now=NOW,
                        **t.kw())
        assert [os.path.basename(d.path) for d in dels] == names, name
    t = Tree(tmp_path / "usage", seed=0)
    _usage_tree(t)
    use = tgc.usage(str(t.root), **t.kw())
    assert use["planes"]["cache"] == {"files": 1, "bytes": 500}
    assert use["planes"]["spool"] == {"files": 2, "bytes": 150}
    assert use["planes"]["journals"]["files"] == 2
    assert use["tenants"]["acme"] == {"upload_bytes": 300, "accepted": 1,
                                      "spool_bytes": 100}


# -- the compile store ---------------------------------------------------------

def _entry(t: Tree, family: str, key: str, env_fp: str, age_s: float):
    d = t.compile / family / key[:2] / key
    t.file(str((d / "_entry.json").relative_to(t.base)),
           text={"env_fp": env_fp})
    t.file(str((d / "blob.so").relative_to(t.base)), 100)
    t.age(d, age_s)
    return d


def test_plan_compile_equals_jax(tmp_path):
    t = Tree(tmp_path, seed=7)
    _entry(t, "i3d", "aa11", FP, 9000.0)       # this host's: kept
    _entry(t, "i3d", "bb22", "ffff", 9000.0)   # foreign and idle: pruned
    _entry(t, "raft", "cc33", "ffff", 10.0)    # foreign but young: kept
    args = {"gc_compile_retention_s": 1000}
    port = tgc.plan(str(t.root), tgc.GcConfig.from_args(args), now=NOW,
                    **t.kw())
    jax = jgc.plan(str(t.root), jgc.GcConfig.from_args(args), now=NOW,
                   **t.kw())
    assert _deletions(port, tmp_path) == _deletions(jax, tmp_path)
    assert [os.path.basename(d.path) for d in port] == ["bb22"]
    assert port[0].is_dir and port[0].bytes > 0


def test_plan_compile_pins_the_attached_entry_and_the_build_dir(
        tmp_path, monkeypatch):
    """The port's own rules: the entry this process attached and the
    directory ``kernels/build.py`` loads from are never planned, whatever
    their fingerprint and age; a foreign entry past retention is."""
    from video_features_tpu_torch import compile_cache as tcc
    from video_features_tpu_torch.kernels import build
    t = Tree(tmp_path, seed=8)
    attached = _entry(t, "i3d", "dd44", "eeee", 9000.0)
    loading = _entry(t, "i3d", "ee55", "eeee", 9000.0)
    _entry(t, "i3d", "ff66", "eeee", 9000.0)
    monkeypatch.setattr(tcc, "_active", tcc.CompileCacheEntry(
        str(t.compile), "i3d", "cfg", "eeee"))
    monkeypatch.setattr(tcc._active, "key", attached.name)
    monkeypatch.setattr(build, "library_dir", lambda: loading)
    dels = tgc.plan_compile(str(t.compile), tgc.GcConfig(
        compile_retention_s=60.0), NOW)
    assert [os.path.basename(d.path) for d in dels] == ["ff66"]
    # no retention: the plane is only accounted
    assert tgc.plan_compile(str(t.compile), tgc.GcConfig(), NOW) == []


def test_fingerprint_once_a_sweep_and_never_for_usage(tmp_path,
                                                      monkeypatch):
    from video_features_tpu_torch import compile_cache as tcc
    calls = []
    monkeypatch.setattr(tcc, "env_fingerprint",
                        lambda: calls.append(1) or ({}, FP))
    t = Tree(tmp_path, seed=9)
    for i in range(3):
        _entry(t, "i3d", f"{i:02x}77", "ffff", 9000.0)
    cfg = tgc.GcConfig(compile_retention_s=60.0)
    tgc.usage(str(t.root), **t.kw())
    tgc.GcMonitor(str(t.root), cfg, **t.kw()).section()
    assert calls == []
    res = tgc.sweep(str(t.root), cfg, dry_run=True, **t.kw())
    assert calls == [1] and res["planned"] == 3
    # an empty store asks for no fingerprint at all
    assert tgc.plan_compile(str(tmp_path / "none"), cfg, NOW) == []
    assert calls == [1]


# -- journaled execution --------------------------------------------------------

def test_journal_records_equal_jax(tmp_path):
    """The same plan executed on twin trees: equal tallies, and journal
    records equal field for field apart from the host and the time (and
    the absolute path, which names each twin)."""
    recs, tallies = {}, {}
    for name, mod in (("port", tgc), ("jax", jgc)):
        t = Tree(tmp_path / name, seed=11)
        args = _every_plane(t)
        dels = mod.plan(str(t.root), mod.GcConfig.from_args(args), now=NOW,
                        **t.kw())
        tallies[name] = mod.execute(str(t.root), dels, host_id=f"{name}-h")
        jpath = t.root / mod.journal_filename(f"{name}-h")
        recs[name] = []
        for r in read_jsonl(jpath):
            assert r.pop("host_id") == f"{name}-h"
            assert abs(r.pop("time") - time.time()) < 60
            r["path"] = os.path.relpath(r["path"], t.base)
            recs[name].append(r)
        assert not [d for d in dels if os.path.exists(d.path)]
    assert tallies["port"] == tallies["jax"]
    assert recs["port"] == recs["jax"] and len(recs["port"]) >= 8
    assert {r["schema"] for r in recs["port"]} == {"vft.gc_event/1"}
    assert tgc.journal_filename("a b/c") == jgc.journal_filename("a b/c")


def test_execute_converges_and_dry_run_deletes_nothing(tmp_path):
    t = Tree(tmp_path, seed=12)
    victim = t.file("cache/aa/aa.pkl", 100, age_s=5000.0)
    cfg = tgc.GcConfig(cache_retention_s=1000.0)
    res = tgc.sweep(str(t.root), cfg, dry_run=True, **t.kw())
    assert res["planned"] == 1 and res["planned_bytes"] == 100
    assert res["executed"] == {} and res["dry_run"] and victim.exists()
    assert not list(t.root.glob(tgc.GC_JOURNAL_GLOB))
    assert "dry run" in "\n".join(tgc.render_report(res))
    dels = tgc.plan(str(t.root), cfg, **t.kw())
    assert tgc.execute(str(t.root), dels, host_id="h") == {
        "cache": {"deleted": 1, "bytes": 100, "errors": 0}}
    # the same plan again: a sibling got there first, no error (counted
    # as converged, as in JAX)
    assert tgc.execute(str(t.root), dels, host_id="h")["cache"][
        "errors"] == 0


def test_render_report_equals_jax(tmp_path):
    t = Tree(tmp_path, seed=13)
    args = _every_plane(t)
    lines = {}
    for name, mod in (("port", tgc), ("jax", jgc)):
        res = mod.sweep(str(t.root), mod.GcConfig.from_args(args),
                        dry_run=True, **t.kw())
        res["usage"]["time"] = 0.0
        lines[name] = mod.render_report(res)
    assert lines["port"][0] == f"gc: {t.root}"
    assert lines["jax"][0] == f"vft-gc: {t.root}"
    assert lines["port"][1:] == lines["jax"][1:]


# -- the gc chaos matrix ---------------------------------------------------------

#: JAX tests/test_chaos.py GC_CHAOS_PLANS
GC_CHAOS_PLANS = {
    40: "seed=40;gc.evict=drop@n1",
    41: "seed=41;gc.sweep=stall@n1;gc.evict=eio@n1",
}


def _gc_litter(tmp_path):
    """3 cold cache entries and 3 expired spool responses, every mtime
    1000 s in the past."""
    root = tmp_path / "out"
    cache = tmp_path / "cache"
    old = time.time() - 1000.0
    for i in range(3):
        p = cache / f"{i:02x}" / f"{i:02x}beef.pkl"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x" * 64)
        os.utime(p, (old, old))
    (root / "done").mkdir(parents=True)
    for i in range(3):
        p = root / "done" / f"rid{i}.json"
        p.write_text(json.dumps({"id": f"rid{i}", "status": "done"}))
        os.utime(p, (old, old))
    return root, cache


def _audits(root) -> tuple:
    """The port's and JAX's audit of one tree, which must agree."""
    port = taudit_run(str(root))
    assert port == jaudit_run(str(root))
    return port


@pytest.mark.parametrize("seed", sorted(GC_CHAOS_PLANS))
def test_gc_chaos_matrix(tmp_path, seed):
    from video_features_tpu_torch.utils import inject

    root, cache = _gc_litter(tmp_path)
    cfg = tgc.GcConfig.from_args({"gc_cache_retention_s": 100,
                                  "gc_spool_retention_s": 100})
    kw = dict(cache_dir=str(cache), compile_dir=str(tmp_path / "cc"))
    plan = inject.arm_for_run(GC_CHAOS_PLANS[seed])
    try:
        result = tgc.sweep(str(root), cfg, **kw)
    finally:
        inject.disarm()

    assert result["planned"] == 6
    assert plan.fired.get("gc.evict") == 1
    if seed == 41:
        assert plan.fired.get("gc.sweep") == 1
        # the injected EIO is a counted error, never a crashed sweep
        assert result["executed"]["cache"]["errors"] == 1
    # exactly one deletion journaled but not done; the other five done
    assert len(list(root.glob("_gc_*.jsonl"))) == 1
    remnants = [*cache.rglob("*.pkl"), *(root / "done").glob("*.json")]
    assert len(remnants) == 1, remnants

    ok, violations, notes = _audits(root)
    assert ok, "\n".join(violations)
    assert any("gc-journaled" in n for n in notes), notes

    # an un-faulted sweep converges: the remnant still satisfies its
    # planner, is journaled again, and this time unlinked
    result2 = tgc.sweep(str(root), cfg, **kw)
    assert result2["planned"] == 1
    assert not list(cache.rglob("*.pkl"))
    assert not list((root / "done").glob("*.json"))
    ok, violations, notes = _audits(root)
    assert ok, "\n".join(violations)
    assert not any("gc-journaled" in n for n in notes), notes


def _gc_module(args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "video_features_tpu_torch", "gc", *args],
        cwd=str(REPO), env=dict(os.environ, **(env or {})),
        capture_output=True, text=True, timeout=300)


def test_sigkill_mid_sweep_audits_clean_and_converges(tmp_path):
    """``gc.evict=kill@n2`` SIGKILLs the command between the second
    journal append and its unlink: one deletion done, the second journaled
    and on disk; both audits pass with the ``gc-journaled`` note; an
    un-faulted rerun converges to an empty store and audits without it."""
    root, cache = _gc_litter(tmp_path)
    flags = [str(root), "--cache-dir", str(cache), "--compile-dir",
             str(tmp_path / "cc"), "--quota-gb", "1e-9"]
    proc = _gc_module(flags, {"VFT_INJECT": "seed=7;gc.evict=kill@n2"})
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-800:]
    assert len(list(cache.rglob("*.pkl"))) == 2
    recs = list(read_jsonl(next(root.glob("_gc_*.jsonl"))))
    assert len(recs) == 2 and os.path.exists(recs[1]["path"])
    ok, violations, notes = _audits(root)
    assert ok, violations
    assert any("gc-journaled" in n for n in notes), notes
    proc = _gc_module(flags + ["--json"])
    assert proc.returncode == 0, proc.stderr[-800:]
    assert json.loads(proc.stdout)["executed"]["cache"]["deleted"] == 2
    assert not list(cache.rglob("*.pkl"))
    ok, violations, notes = _audits(root)
    assert ok and not any("gc-journaled" in n for n in notes), notes


# -- the monitor -----------------------------------------------------------------

class Clock:
    def __init__(self, t: float = NOW) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_monitor_caches_walks_on_interval_as_jax(tmp_path):
    t = Tree(tmp_path, seed=14)
    _usage_tree(t)
    sections = {}
    for name, mod in (("port", tgc), ("jax", jgc)):
        clk = Clock()
        mon = mod.GcMonitor(str(t.root), mod.GcConfig(quota_gb=1.0,
                                                      interval_s=60.0),
                            clock=clk, **t.kw())
        sections[name] = [mon.section()]
        # inside the interval the cached snapshot is published again
        extra = t.file(f"cache/{name}/{name}.pkl", 50)
        sections[name].append(mon.section())
        clk.t += 61.0
        sections[name].append(mon.section())
        extra.unlink()
    port = sections["port"]
    assert port == sections["jax"]
    assert port[0]["quota_bytes"] == int(1e9)
    assert port[0]["used_bytes"] == port[1]["used_bytes"]
    assert port[2]["used_bytes"] == port[0]["used_bytes"] + 50
    assert port[0]["tenants"] == {"acme": 400}


def test_monitor_attach_publishes_gauges(tmp_path):
    from video_features_tpu_torch.telemetry.recorder import (
        TelemetryRecorder)
    t = Tree(tmp_path, seed=15)
    t.file("cache/aa/aa.pkl", 100)
    rec = TelemetryRecorder(str(t.root))
    mon = tgc.GcMonitor(str(t.root), tgc.GcConfig(quota_gb=1.0),
                        **t.kw()).attach(rec)
    assert rec.extra_sections["gc"] == mon.section
    mon.snapshot()
    assert rec.registry.gauge("vft_gc_used_bytes").value == 100
    assert rec.registry.gauge("vft_gc_quota_bytes").value == int(1e9)
    assert rec.registry.gauge("vft_gc_plane_bytes",
                              plane="cache").value == 100


def _cli(argv):
    from video_features_tpu_torch.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def monitored_runs(tmp_path_factory, sample_video):
    """Two resnet18 CLI runs on the CPU with ``telemetry history alerts``:
    ``gc=false``, then ``gc=true`` with a quota far below the root's use,
    so that ``disk_pressure`` fires from the port's own samples. The
    monitor walks the stores' default locations, as in JAX: here the
    test's own."""
    tmp = tmp_path_factory.mktemp("gc_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("VFT_CACHE_DIR", str(tmp / "fc"))
    mp.setenv("VFT_COMPILE_CACHE_DIR", str(tmp / "cc"))
    runs = {}
    try:
        for name, extra in (("off", []), ("on", [
                "gc=true", "gc_quota_gb=1e-6", "gc_interval_s=0.001",
                "gc_cache_retention_s=3600"])):
            out = _cli(["feature_type=resnet", "model_name=resnet18",
                        "device=cpu", "allow_random_weights=true",
                        "extraction_total=2", "on_extraction=save_numpy",
                        "telemetry=true", "history=true", "alerts=true",
                        "metrics_interval_s=0.3",
                        f"output_path={tmp / name}",
                        f"tmp_path={tmp / 'tmp'}",
                        f"video_paths={sample_video}"] + extra)
            runs[name] = dict(stdout=out, dir=tmp / name / "resnet" /
                              "resnet18")
    finally:
        mp.undo()
    return runs


def _beat(run_dir: Path) -> dict:
    return json.loads(next(run_dir.glob("_heartbeat_*.json")).read_text())


def _series(run_dir: Path) -> dict:
    man = json.loads((run_dir / "_run.json").read_text())
    return {(s["name"], tuple(sorted(s.get("labels", {}).items()))):
            s.get("value") for s in man["metrics"]["series"]}


def test_gc_true_publishes_section_metrics_and_history(monitored_runs):
    from video_features_tpu_torch.telemetry import history
    run_dir = monitored_runs["on"]["dir"]
    sec = _beat(run_dir)["gc"]
    assert sec["quota_bytes"] == 1000 and sec["used_bytes"] > 0
    assert set(sec["planes"]) == set(tgc.PLANES)
    assert sec["planes"]["journals"] > 0
    series = _series(run_dir)
    assert series[("vft_gc_used_bytes", ())] > 0
    assert series[("vft_gc_quota_bytes", ())] == 1000
    assert ("vft_gc_plane_bytes", (("plane", "journals"),)) in series
    samples = [s for ss in history.read_history(str(run_dir)).values()
               for s in ss]
    # the first sample is the start's (nothing written yet), the last the
    # final heartbeat's
    assert samples and all(s["gc"]["quota_bytes"] == 1000 for s in samples)
    assert samples[-1]["gc"]["used_bytes"] == sec["used_bytes"] > 0
    assert "1 extracted" in monitored_runs["on"]["stdout"]


def test_disk_pressure_fires_on_the_ports_history(monitored_runs):
    """The disk rule reads the port's own samples: the run fired
    ``disk_pressure`` at its quota level, with an incident bundle."""
    run_dir = monitored_runs["on"]["dir"]
    recs = list(read_jsonl(run_dir / "_alerts.jsonl"))
    firing = [r for r in recs if r["rule"] == "disk_pressure"
              and r["state"] == "firing"]
    assert firing and "quota" in firing[0]["summary"], recs
    assert (run_dir / firing[0]["incident"]).is_dir()


def test_gc_false_registers_nothing(monitored_runs):
    off, on = (monitored_runs[k]["dir"] for k in ("off", "on"))
    assert "gc" not in _beat(off)
    assert not [k for k in _series(off) if k[0].startswith("vft_gc_")]
    assert not [r for r in read_jsonl(off / "_alerts.jsonl")
                if r["rule"] == "disk_pressure"]
    names = sorted(p.name for p in off.glob("*.npy"))
    assert names == sorted(p.name for p in on.glob("*.npy")) and names
    for n in names:
        assert (off / n).read_bytes() == (on / n).read_bytes()


# -- the gc subcommand ----------------------------------------------------------

def test_gc_subcommand_one_shot_json(tmp_path, capsys):
    from video_features_tpu_torch.cli import main
    t = Tree(tmp_path, seed=16)
    t.file("cache/aa/aa.pkl", 64)  # years before the real clock
    with pytest.raises(SystemExit) as e:
        main(["gc", str(t.root), "--cache-dir", str(t.cache),
              "--compile-dir", str(t.compile), "--cache-retention-s",
              "1000", "--json"])
    assert e.value.code == 0
    out = json.loads(capsys.readouterr().out)
    assert out["planned"] == 1 and not out["dry_run"]
    assert out["executed"]["cache"]["deleted"] == 1
    assert not (t.cache / "aa" / "aa.pkl").exists()
    assert list(t.root.glob(tgc.GC_JOURNAL_GLOB))


def test_gc_subcommand_watch_iterations(tmp_path, capsys):
    t = Tree(tmp_path, seed=17)
    t.file("cache/aa/aa.pkl", 64)
    assert tgc.main([str(t.root), "--cache-dir", str(t.cache),
                     "--compile-dir", str(t.compile), "--watch",
                     "--every", "0.05", "--iterations", "2",
                     "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert out.count("== usage ==") == 2 and "dry run" in out


@pytest.mark.parametrize("flags,match", [
    (["--quota-gb", "-1"], "gc_quota_gb"),
    (["--quota-gb", "0"], "gc_quota_gb"),
    (["--spool-retention-s", "0"], "gc_spool_retention_s"),
    (["--every", "-5"], "gc_interval_s"),
])
def test_gc_subcommand_rejects_bad_flags(tmp_path, flags, match):
    from video_features_tpu_torch.cli import main
    for run in (lambda: main(["gc", str(tmp_path)] + flags),
                lambda: jgc.main([str(tmp_path)] + flags)):
        with pytest.raises(ValueError, match=match):
            run()
    assert tgc.main([str(tmp_path / "missing")]) == 2
