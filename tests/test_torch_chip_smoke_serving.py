"""chip_smoke.py's serving phases (steps 21-24) on the CPU at a small size:
the serve, compile-cache, fleet-queue and storage phases. A file of its own,
split from tests/test_torch_chip_smoke.py: its module fixture takes minutes,
so xdist's ``--dist loadfile`` runs it on a worker apart from the run-plane
phases (tests/test_torch_chip_smoke_run_plane.py). The script is imported
without running ``main()``."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


#: the telemetry test's small sizes: one 10-frame stack, 2 RAFT iterations
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1)


FAKE_NVCC = """#!{python}
import sys
a = sys.argv[1:]
if "--version" in a:
    print("Cuda compilation tools, release 12.4, V12.4.131")
    sys.exit(0)
with open(a[a.index("-o") + 1], "wb") as f:
    f.write(b"stand-in kernel library " + " ".join(a).encode())
print("ptxas info    : Compiling entry function '_Z4fakev' for 'sm_90a'")
"""


@pytest.fixture(scope="module")
def serving_phases(tmp_path_factory, sample_video):
    """The serve, compile-cache and fleet-queue phases on the CPU at
    :data:`SMALL` in one working directory (the fleet phase reads the
    serve phase's spool); the compile-cache phase's subprocesses build
    through a stand-in ``nvcc`` (a script that writes its ``-o`` file,
    found through ``CUDA_HOME``)."""
    import sys
    work = tmp_path_factory.mktemp("serving")
    nvcc = work / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    # the phases' subprocesses keep this worker's share of the cores
    # (tests/test_torch_threads.py)
    mp.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    try:
        serve = cs.serve_phase(video=sample_video, **SMALL)
        compile_cache = cs.compile_cache_phase(
            video=sample_video, env={"CUDA_HOME": str(work / "cuda")},
            **SMALL)
        # the fleet phase's five subprocesses extract ten videos: on the
        # RGB stream alone, since RAFT's 10-pair stack takes 10-15 s on
        # the one thread a worker gets and the queue, the canary and the
        # reports are what the phase holds
        fleet = cs.fleet_queue_phase(video=sample_video,
                                     **dict(SMALL, streams="rgb"))
        # the storage phase's in-process attach fingerprints the stand-in
        # toolkit as the compile phase's subprocesses did
        mp.setenv("CUDA_HOME", str(work / "cuda"))
        storage = cs.storage_phase(
            video=sample_video,
            trees={k: cs.STORAGE_TREES[k]
                   for k in ("serve", "compile_cache", "fleet_queue")},
            reference=f"{cs.SERVE_ROOT}/cli/out/i3d",
            env={"CUDA_HOME": str(work / "cuda")}, **SMALL)
        yield dict(serve=serve, compile_cache=compile_cache, fleet=fleet,
                   storage=storage)
    finally:
        mp.undo()


def test_serve_phase_runs_on_the_cpu(serving_phases):
    """Three HTTP requests through the gateway to the in-process server:
    the sample, a cache hit that decodes no frame, an expired one; no
    lookup kernel launches on the CPU."""
    stats = serving_phases["serve"]
    req = stats["requests"]
    assert [req[k]["status"] for k in ("first", "copy", "expired")] == [
        "done", "done", "deadline_exceeded"]
    assert req["copy"]["frames_decoded"] == 0
    assert req["first"]["frames_decoded"] > 0
    assert all(r["launches"] == {"level": 0, "proj": 0, "packed": 0}
               for r in req.values())
    assert req["first"]["queue_wait_s"] >= 0 and req["first"]["service_s"] > 0
    assert stats["server"]["state"] == "exited" and stats["stacks"] == 1
    assert stats["gateway"]["accepted"] == 3
    assert stats["loop_rc"] in (0, 143)
    json.dumps(stats)


def test_compile_cache_phase_runs_on_the_cpu(serving_phases):
    """Warmup, a warm join with no build, a corrupt library dropped and
    rebuilt, through the stand-in nvcc."""
    stats = serving_phases["compile_cache"]
    assert stats["warm_join"]["misses"] == 0
    assert stats["warm_join"]["hits"] >= 1
    assert stats["warm_join"]["warm_at_attach"] is True
    assert stats["cold_join"]["misses"] == 1
    assert stats["cold_join"]["dropped"] >= 1
    assert stats["entry"]["nvcc"] == "12.4"
    assert stats["entry"]["device_name"] == "cpu"
    assert min(stats["warmup_wall_s"], stats["warm_join_wall_s"],
               stats["cold_join_wall_s"]) > 0


def test_fleet_queue_phase_runs_on_the_cpu(serving_phases):
    """Three copies through one and two queue workers, each done once and
    bit-equal to the static run; the canary host passes on the digest
    band; the report and the observation read both roots."""
    stats = serving_phases["fleet"]
    assert sum(stats["done_by_host"]) == 3
    assert stats["single_proj_launches"] == 0
    assert stats["makespan_one_worker_s"] > 0
    assert stats["makespan_two_workers_s"] > 0
    assert any("digest(s) compared" in ln and ln.endswith("PASS")
               for ln in stats["canary_lines"])
    assert stats["report_queue"]["done"] == 3
    assert stats["report_serve"]["requests"] >= 2
    assert stats["observe_hosts"]["queue"] >= 2
    json.dumps(stats)


def test_storage_phase_runs_on_the_cpu(serving_phases):
    """The storage phase over the serving phases' trees: the dry-run
    accounting finds each plane they wrote; the gc=true run publishes its
    section; eviction journals every entry and the refill recomputes it;
    the SIGKILLed sweep audits clean and converges; the foreign compile
    entry is pruned and the warm join hits; every tree audits PASS."""
    stats = serving_phases["storage"]
    acc = stats["accounting"]
    assert acc["serve"]["planes"]["spool"] > 0
    assert acc["serve"]["planes"]["cache"] > 0
    assert acc["compile_cache"]["planes"]["compile"] > 0
    assert acc["fleet_queue"]["planes"]["journals"] > 0
    assert all(v["planned"] == 0 for v in acc.values())
    assert min(stats["usage_walk_s"].values()) > 0
    mon = stats["monitor"]
    assert mon["proj_launches"] == 0 and mon["history_samples"] >= 1
    assert 0 < mon["used_bytes"] and mon["quota_bytes"] > 0
    ev = stats["eviction"]
    assert ev["entries"] >= 1 and ev["journal_records"] == ev["entries"]
    assert ev["executed"]["cache"]["deleted"] == ev["entries"]
    assert stats["refill_proj_launches"] == 0
    assert stats["refill_wall_s"] > 0 and stats["hit_wall_s"] > 0
    kill = stats["killed_sweep"]
    assert kill["exit"] == -9 and kill["survivors"] == kill["entries"] - 1
    assert kill["rerun"]["executed"]["cache"]["deleted"] == \
        kill["survivors"]
    assert stats["compile_prune"]["executed"]["compile"]["deleted"] == 1
    assert stats["compile_prune"]["kept"] == stats["compile_prune"]["pinned"]
    assert stats["warm_join"]["compile_cache"]["misses"] == 0
    audits = stats["audits"]
    assert set(audits) == {"serve", "compile_cache", "fleet_queue",
                           "storage", "gc_killed", "gc_converged"}
    assert {a["verdict"] for a in audits.values()} == {"PASS"}
    assert audits["gc_killed"]["notes"] >= 1
    json.dumps(stats)
