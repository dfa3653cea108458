"""The port's run comparison (``compare_runs.py``) against the JAX
package's ``scripts/compare_runs.py``, loaded by path.

Both ``compare()`` functions run over the same pairs of trees: a
self-compare gives ``PASS`` and a seeded drift in each layer (feature
digests, stage timings, failure journals, written artifacts) gives
``FAIL``, with the same exit code and the same itemised report, line for
line. ``--selftest`` and the exit codes of ``main`` (0, 1, 2) and of the
``compare`` subcommand, which imports no torch, as ``loadgen``'s does not.
The fleet canary takes its digest band from this module.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu_torch import compare_runs
from video_features_tpu_torch.telemetry import health
from video_features_tpu_torch.telemetry.jsonl import (append_jsonl,
                                                      write_json_atomic)

REPO = Path(__file__).resolve().parent.parent


def _jax_compare_runs():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_runs", REPO / "scripts" / "compare_runs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _jax_compare_runs()


def _features(seed=7):
    rng = np.random.default_rng(seed)
    return {
        "resnet": {"v_a.mp4": rng.standard_normal((12, 64)).astype("f4"),
                   "v_b.mp4": rng.standard_normal((9, 64)).astype("f4")},
        "clip": {"v_a.mp4": rng.standard_normal((12, 32)).astype("f4")},
    }


def _tree(root, feats, stages, failures, artifacts):
    """A run root: each family's ``_health.jsonl``, ``_run.json`` stage
    totals, ``_failures.jsonl`` and span ``artifact`` events."""
    for fam, vids in feats.items():
        fam_dir = os.path.join(root, fam)
        for vid, arr in vids.items():
            health.digest_features({fam: arr}, vid, fam, fam_dir)
        write_json_atomic(os.path.join(fam_dir, "_run.json"),
                          {"stage_totals": stages.get(fam, {})})
        for rec in failures.get(fam, []):
            append_jsonl(os.path.join(fam_dir, "_failures.jsonl"), rec)
        append_jsonl(os.path.join(fam_dir, "_telemetry.jsonl"), {
            "feature_type": fam,
            "events": [{"kind": "artifact", "file": f, "bytes": n,
                        "sha256": sha}
                       for f, (n, sha) in artifacts.get(fam, {}).items()]})


STAGES = {"resnet": {"decode": {"s": 2.0, "calls": 4},
                     "forward": {"s": 4.0, "calls": 4}},
          "clip": {"decode": {"s": 1.0, "calls": 2}}}
ARTIFACTS = {"resnet": {"v_a_resnet.npy": (3200, "aa"),
                        "v_b_resnet.npy": (2432, "bb")},
             "clip": {"v_a_clip.npy": (1664, "cc")}}
RESOLVED = {"resnet": [{"video": "/d/v_c.mp4", "category": "TRANSIENT",
                        "attempts": 1, "error": "EIO"},
                       {"video": "/d/v_c.mp4", "category": "RESOLVED"}]}


def _drift(kind):
    """(features, stages, failures, artifacts) of a candidate run with one
    seeded drift of ``kind``."""
    feats, stages = _features(), json.loads(json.dumps(STAGES))
    failures, artifacts = dict(RESOLVED), json.loads(json.dumps(ARTIFACTS))
    if kind == "digest":
        feats["resnet"]["v_a.mp4"] = feats["resnet"]["v_a.mp4"] + 0.063
        feats["clip"]["v_a.mp4"][0, 0] = np.nan
    elif kind == "within_band":
        feats["resnet"]["v_b.mp4"] = feats["resnet"]["v_b.mp4"] + 1e-4
    elif kind == "shape":
        feats["clip"]["v_a.mp4"] = feats["clip"]["v_a.mp4"][:11]
    elif kind == "stage":
        stages["resnet"]["forward"]["s"] = 9.0
    elif kind == "failure":
        failures = {"resnet": [{"video": "/d/v_d.mp4", "category": "POISON",
                                "attempts": 3, "error": "cannot decode"}]}
    elif kind == "artifact":
        artifacts["resnet"]["v_a_resnet.npy"] = (1600, "zz")
        artifacts["clip"]["v_a_clip.npy"] = (1700, "dd")
    return feats, stages, failures, artifacts


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cmp") / "run_a")
    _tree(root, _features(), STAGES, RESOLVED, ARTIFACTS)
    return root


def _both(run_a, run_b, **kw):
    got = compare_runs.compare(run_a, run_b, **kw)
    want = JAX.compare(run_a, run_b, **kw)
    assert got == want
    return got


def test_self_compare_passes_as_in_jax(baseline, tmp_path):
    copy = str(tmp_path / "run_b")
    shutil.copytree(baseline, copy)
    for b in (baseline, copy):
        rc, lines = _both(baseline, b)
        assert rc == 0, lines
        assert lines[-1].startswith("vft-compare: PASS — 3 digests")


@pytest.mark.parametrize("kind,rc,needles", [
    ("digest", 1, ["digest drift beyond atol=0.01/rtol=0.02 for "
                   "resnet/v_a.mp4:resnet", "non-finite values introduced"]),
    ("within_band", 0, ["content moved within tolerance"]),
    ("shape", 1, ["shape/dtype changed for clip/v_a.mp4:clip"]),
    ("stage", 1, ["SLOWER stage forward: 1000.00 -> 2250.00 ms/call"]),
    ("failure", 1, ["NEW  new failure in candidate: v_d.mp4 (resnet): "
                    "POISON after 3 attempt(s)"]),
    ("artifact", 1, ["artifact shrank: v_a_resnet.npy (resnet) 3200 -> "
                     "1600 bytes", "1 artifact(s) changed bytes"]),
])
def test_seeded_drift_matches_jax(baseline, tmp_path, kind, rc, needles):
    run_b = str(tmp_path / "run_b")
    _tree(run_b, *_drift(kind))
    got_rc, lines = _both(baseline, run_b)
    text = "\n".join(lines)
    assert got_rc == rc, text
    for needle in needles:
        assert needle in text, text
    assert lines[-1].startswith("vft-compare: " + ("PASS" if rc == 0
                                                   else "FAIL"))


def test_bands_are_the_jax_defaults(baseline, tmp_path):
    """Tighter and looser bands move the same verdicts in both."""
    run_b = str(tmp_path / "run_b")
    _tree(run_b, *_drift("within_band"))
    assert _both(baseline, run_b, atol=0.0, rtol=0.0)[0] == 1
    run_c = str(tmp_path / "run_c")
    _tree(run_c, *_drift("stage"))
    assert _both(baseline, run_c, stage_band=2.0)[0] == 0
    assert _both(baseline, run_c, min_stage_s=10.0)[0] == 0


def test_main_exit_codes(baseline, tmp_path, capsys):
    run_b = str(tmp_path / "run_b")
    _tree(run_b, *_drift("digest"))
    assert compare_runs.main([baseline, baseline]) == 0
    assert "vft-compare: PASS" in capsys.readouterr().out
    assert compare_runs.main([baseline, run_b]) == 1
    assert "vft-compare: FAIL" in capsys.readouterr().out
    assert compare_runs.main([baseline, str(tmp_path / "nope")]) == 2
    with pytest.raises(SystemExit) as e:
        compare_runs.main([baseline])
    assert e.value.code == 2
    assert compare_runs.main(["--selftest"]) == 0
    assert "compare_runs selftest OK" in capsys.readouterr().out


def test_the_canary_takes_its_digest_band_from_compare_runs():
    from video_features_tpu_torch.parallel import queue
    assert queue.load_health is compare_runs.load_health
    assert queue.compare_digests is compare_runs.compare_digests


_NO_TORCH = textwrap.dedent("""
    import runpy, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("torch", "jax", "video_features_tpu"):
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.argv = ["video_features_tpu_torch"] + sys.argv[1:]
    runpy.run_module("video_features_tpu_torch", run_name="__main__")
""")


@pytest.mark.parametrize("args,rc,needle", [
    (["compare", "--help"], 0, "--stage-band"),
    (["compare", "--selftest"], 0, "compare_runs selftest OK"),
    (["loadgen", "--help"], 0, "--emit-tenants"),
    (["loadgen", "scenarios/steady.yml", "--spool", "{tmp}/spool",
      "--host-id", "h", "--dry-run"], 0, "38 offered request(s)"),
    (["loadgen", "scenarios/steady.yml", "--spool", "{tmp}/spool"], 2,
     "--base-url is required"),
])
def test_subcommands_import_no_torch(tmp_path, args, rc, needle):
    args = [a.format(tmp=tmp_path) for a in args]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", _NO_TORCH, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == rc, run.stdout + run.stderr
    assert needle in run.stdout + run.stderr


def test_cli_main_routes_compare_and_loadgen(baseline, tmp_path):
    from video_features_tpu_torch import cli
    with pytest.raises(SystemExit) as e:
        cli.main(["compare", baseline, baseline])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        cli.main(["loadgen", str(REPO / "scenarios" / "steady.yml"),
                  "--spool", str(tmp_path / "spool"), "--host-id", "h",
                  "--dry-run"])
    assert e.value.code == 0
    assert (tmp_path / "spool" / "_loadgen_h.jsonl").exists()
