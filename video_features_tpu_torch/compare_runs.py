"""Diff two runs' artifacts into one regression verdict (port of
``scripts/compare_runs.py``).

    python -m video_features_tpu_torch compare RUN_A RUN_B
    python -m video_features_tpu_torch compare A B --rtol 0.02 --atol 1e-2
    python -m video_features_tpu_torch compare --selftest

Takes two output directories (each a ``telemetry=true``/``health=true``
run root; per-family subdirs are found recursively) and answers: did the
outputs move, and did the run get slower? Three layers, all read from
artifacts alone:

  1. feature digests (``_health.jsonl``, ``telemetry/health.py``): per
     (video, family, key), a changed shape or dtype and newly non-finite
     values fail; equal content signatures are the identical fast path;
     otherwise min/max/mean/std/l2 must agree within
     ``atol + rtol * |baseline|`` (the defaults are the value tier's
     atol=1e-2);
  2. stage timings (``_run.json`` ``stage_totals``): a stage whose ms per
     call grew beyond ``--stage-band`` (and that spends at least
     ``--min-stage-s`` in all) is a regression;
  3. failure journals (``_failures.jsonl``) and artifact events (the span
     ``artifact`` events' bytes and sha256): videos that newly fail, and
     written files that shrank, without reading any feature file.

Exit 0 with a ``vft-compare: PASS`` line when run B is within every band
of run A; exit 1 with ``vft-compare: FAIL`` and the itemised drift list
otherwise; 2 when a run directory is missing. An identical self-compare
passes by construction; ``--selftest`` builds a seeded-drift fixture and
checks both directions. The report's wording is the JAX script's, line for
line, so one grep serves both packages' verdicts.

Imports no torch: the command starts as fast as ``gc`` and ``audit``. The
fleet canary (``parallel/queue.py``) holds a joining host to the same
digest band through :func:`load_health` and :func:`compare_digests`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .telemetry.health import HEALTH_FILENAME
from .telemetry.jsonl import read_jsonl
from .telemetry.manifest import MANIFEST_FILENAME
from .telemetry.recorder import SPANS_FILENAME

#: digest stats compared against the atol + rtol * |baseline| band
STAT_KEYS = ("min", "max", "mean", "std", "l2")


# -- artifact loading (recursive: run roots contain per-family subdirs) ------

def load_health(root: str) -> Dict[Tuple[str, str, str], dict]:
    """Latest digest per (video basename, family, key) under ``root``."""
    out: Dict[Tuple[str, str, str], dict] = {}
    for path in sorted(Path(root).rglob(HEALTH_FILENAME)):
        for rec in read_jsonl(path):
            k = (os.path.basename(str(rec.get("video"))),
                 str(rec.get("feature_type")), str(rec.get("key")))
            out[k] = rec  # last record wins: re-runs supersede
    return out


def load_stage_totals(root: str) -> Dict[str, Dict[str, float]]:
    """Summed stage totals across every ``_run.json`` under ``root``."""
    out: Dict[str, Dict[str, float]] = {}
    for path in sorted(Path(root).rglob(MANIFEST_FILENAME)):
        try:
            man = json.load(open(path, encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            continue
        for name, v in (man.get("stage_totals") or {}).items():
            agg = out.setdefault(name, {"s": 0.0, "calls": 0})
            agg["s"] += float(v.get("s", 0.0))
            agg["calls"] += int(v.get("calls", 0))
    return out


def load_failures(root: str) -> Dict[Tuple[str, str], dict]:
    """Latest non-RESOLVED journal verdict per (journal dir, video)."""
    out: Dict[Tuple[str, str], dict] = {}
    for path in sorted(Path(root).rglob("_failures.jsonl")):
        rel = str(path.parent.relative_to(root))
        for rec in read_jsonl(path):
            k = (rel, os.path.basename(str(rec.get("video"))))
            if rec.get("category") == "RESOLVED":
                out.pop(k, None)
            else:
                out[k] = rec
    return out


def load_artifacts(root: str) -> Dict[Tuple[str, str], Tuple[int, str]]:
    """(family, filename) -> (bytes, sha256) from span ``artifact``
    events — what utils/sinks.py hashed before each atomic rename."""
    out: Dict[Tuple[str, str], Tuple[int, str]] = {}
    for path in sorted(Path(root).rglob(SPANS_FILENAME)):
        for span in read_jsonl(path):
            fam = str(span.get("feature_type"))
            for ev in span.get("events") or []:
                if ev.get("kind") == "artifact" and "sha256" in ev:
                    out[(fam, str(ev.get("file")))] = (
                        int(ev.get("bytes", 0)), str(ev["sha256"]))
    return out


# -- comparison layers ------------------------------------------------------

def _within(a: Optional[float], b: Optional[float],
            atol: float, rtol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(float(a) - float(b)) <= atol + rtol * abs(float(a))


def compare_digests(da: dict, db: dict, atol: float, rtol: float
                    ) -> Tuple[List[str], List[str], int]:
    """(failures, infos, n_compared) for run B's digests vs run A's."""
    fails: List[str] = []
    infos: List[str] = []
    common = sorted(set(da) & set(db))
    for k in common:
        a, b = da[k], db[k]
        label = f"{k[1]}/{k[0]}:{k[2]}"
        if a.get("shape") != b.get("shape") or \
                a.get("dtype") != b.get("dtype"):
            fails.append(
                f"shape/dtype changed for {label}: "
                f"{a.get('shape')}/{a.get('dtype')} -> "
                f"{b.get('shape')}/{b.get('dtype')}")
            continue
        a_bad = int(a.get("nan", 0)) + int(a.get("inf", 0))
        b_bad = int(b.get("nan", 0)) + int(b.get("inf", 0))
        if b_bad > a_bad:
            fails.append(
                f"non-finite values introduced in {label}: "
                f"{b.get('nan')} NaN / {b.get('inf')} Inf "
                f"(baseline had {a_bad})")
            continue
        if a.get("sig") == b.get("sig"):
            continue  # identical within the signature's quantization grid
        drifted = [
            f"{s} {a.get(s):.6g}->{b.get(s):.6g}" for s in STAT_KEYS
            if not _within(a.get(s), b.get(s), atol, rtol)]
        if drifted:
            fails.append(f"digest drift beyond atol={atol}/rtol={rtol} "
                         f"for {label}: " + ", ".join(drifted))
        else:
            infos.append(f"content moved within tolerance for {label} "
                         "(signature changed, stats in band)")
    only_a = sorted(set(da) - set(db))
    only_b = sorted(set(db) - set(da))
    if only_a:
        infos.append(f"{len(only_a)} digest(s) only in baseline "
                     f"(e.g. {'/'.join(only_a[0])})")
    if only_b:
        infos.append(f"{len(only_b)} digest(s) only in candidate "
                     f"(e.g. {'/'.join(only_b[0])})")
    return fails, infos, len(common)


def compare_stages(sa: dict, sb: dict, band: float, min_stage_s: float
                   ) -> Tuple[List[str], List[str]]:
    fails: List[str] = []
    infos: List[str] = []
    for name in sorted(set(sa) & set(sb)):
        a, b = sa[name], sb[name]
        if not a["calls"] or not b["calls"]:
            continue
        a_ms = 1e3 * a["s"] / a["calls"]
        b_ms = 1e3 * b["s"] / b["calls"]
        if a_ms <= 0:
            continue
        ratio = b_ms / a_ms
        line = (f"stage {name}: {a_ms:.2f} -> {b_ms:.2f} ms/call "
                f"({ratio:.2f}x)")
        if ratio > 1.0 + band and max(a["s"], b["s"]) >= min_stage_s:
            fails.append(line + f" — beyond the {1.0 + band:.2f}x band")
        else:
            infos.append(line)
    return fails, infos


def compare_failures(fa: dict, fb: dict) -> Tuple[List[str], List[str]]:
    fails: List[str] = []
    infos: List[str] = []
    new = sorted(set(fb) - set(fa))
    gone = sorted(set(fa) - set(fb))
    for k in new:
        rec = fb[k]
        fails.append(f"new failure in candidate: {k[1]} ({k[0]}): "
                     f"{rec.get('category')} after {rec.get('attempts')} "
                     f"attempt(s): {str(rec.get('error'))[:120]}")
    if gone:
        infos.append(f"{len(gone)} baseline failure(s) no longer fail "
                     f"(e.g. {gone[0][1]})")
    return fails, infos


def compare_artifacts(aa: dict, ab: dict) -> Tuple[List[str], List[str]]:
    fails: List[str] = []
    infos: List[str] = []
    changed = 0
    for k in sorted(set(aa) & set(ab)):
        (a_bytes, a_sha), (b_bytes, b_sha) = aa[k], ab[k]
        if a_sha == b_sha:
            continue
        if b_bytes < a_bytes:
            fails.append(f"artifact shrank: {k[1]} ({k[0]}) "
                         f"{a_bytes} -> {b_bytes} bytes — truncated or "
                         "content-reduced output")
        else:
            changed += 1
    if changed:
        # content changes are judged by the digest layer (which owns the
        # tolerance semantics); the byte layer only reports the count
        infos.append(f"{changed} artifact(s) changed bytes "
                     "(see digest layer for verdicts)")
    return fails, infos


# -- the comparison ---------------------------------------------------------

def compare(run_a: str, run_b: str, *, atol: float = 1e-2,
            rtol: float = 0.02, stage_band: float = 0.5,
            min_stage_s: float = 0.5) -> Tuple[int, List[str]]:
    """Return (exit code, report lines)."""
    lines: List[str] = [f"vft-compare: {run_a} (baseline) vs {run_b} "
                        "(candidate)"]
    fails: List[str] = []

    da, db = load_health(run_a), load_health(run_b)
    d_fails, d_infos, n_digests = compare_digests(da, db, atol, rtol)
    fails += d_fails
    lines.append(f"== feature digests ({len(da)} baseline / {len(db)} "
                 f"candidate, {n_digests} compared) ==")
    lines += [f"  DRIFT {x}" for x in d_fails]
    lines += [f"  note  {x}" for x in d_infos]
    if not (da or db):
        lines.append("  (no _health.jsonl on either side — run with "
                     "health=true to compare outputs)")

    sa, sb = load_stage_totals(run_a), load_stage_totals(run_b)
    s_fails, s_infos = compare_stages(sa, sb, stage_band, min_stage_s)
    fails += s_fails
    lines.append(f"== stage timings ({len(set(sa) & set(sb))} stages in "
                 "both) ==")
    lines += [f"  SLOWER {x}" for x in s_fails]
    lines += [f"  note   {x}" for x in s_infos]

    fa, fb = load_failures(run_a), load_failures(run_b)
    f_fails, f_infos = compare_failures(fa, fb)
    fails += f_fails
    lines.append(f"== failure journals ({len(fa)} baseline / {len(fb)} "
                 "candidate) ==")
    lines += [f"  NEW  {x}" for x in f_fails]
    lines += [f"  note {x}" for x in f_infos]

    aa, ab = load_artifacts(run_a), load_artifacts(run_b)
    a_fails, a_infos = compare_artifacts(aa, ab)
    fails += a_fails
    lines.append(f"== written artifacts ({len(set(aa) & set(ab))} in "
                 "both) ==")
    lines += [f"  BAD  {x}" for x in a_fails]
    lines += [f"  note {x}" for x in a_infos]

    if fails:
        lines.append(
            f"vft-compare: FAIL — {len(d_fails)} digest drift(s), "
            f"{len(s_fails)} stage regression(s), {len(f_fails)} new "
            f"failure(s), {len(a_fails)} artifact problem(s)")
        return 1, lines
    lines.append(
        f"vft-compare: PASS — {n_digests} digests within band, "
        f"{len(set(sa) & set(sb))} stages within {1.0 + stage_band:.2f}x, "
        "no new failures")
    return 0, lines


# -- seeded-drift selftest -----------------------------------------------

def selftest() -> int:
    """Build a seeded-drift fixture and assert both verdict directions:
    identical self-compare PASSes; a perturbed feature (mean shift well
    past atol) plus an injected NaN FAILs with both detections named."""
    import shutil
    import tempfile

    import numpy as np

    from .telemetry import health

    rng = np.random.default_rng(7)
    feats = {
        "resnet": {"v_a.mp4": rng.standard_normal((12, 2048)).astype("f4"),
                   "v_b.mp4": rng.standard_normal((9, 2048)).astype("f4")},
        "clip": {"v_a.mp4": rng.standard_normal((12, 512)).astype("f4")},
    }
    with tempfile.TemporaryDirectory(prefix="vft_compare_selftest_") as td:
        run_a = os.path.join(td, "run_a")
        for fam, vids in feats.items():
            fam_dir = os.path.join(run_a, fam)
            for vid, arr in vids.items():
                health.digest_features({fam: arr}, vid, fam, fam_dir)
        run_b = os.path.join(td, "run_b")
        shutil.copytree(run_a, run_b)

        rc, lines = compare(run_a, run_b)
        print("\n".join(lines))
        if rc != 0:
            print("selftest: identical self-compare must PASS",
                  file=sys.stderr)
            return 1

        # seeded drift: perturb one feature past atol=1e-2 in run B and
        # inject one NaN into another family's tensor
        run_c = os.path.join(td, "run_c")
        for fam, vids in feats.items():
            fam_dir = os.path.join(run_c, fam)
            for vid, arr in vids.items():
                bad = arr.copy()
                if fam == "resnet" and vid == "v_a.mp4":
                    bad = bad + 0.063  # well past atol=1e-2
                if fam == "clip":
                    bad[0, 0] = np.nan
                health.digest_features({fam: bad}, vid, fam, fam_dir)
        rc, lines = compare(run_a, run_c)
        print("\n".join(lines))
        text = "\n".join(lines)
        if rc == 0:
            print("selftest: seeded drift must FAIL the compare",
                  file=sys.stderr)
            return 1
        if "digest drift" not in text or "non-finite" not in text:
            print("selftest: both the perturbation and the injected NaN "
                  "must be named in the report", file=sys.stderr)
            return 1
    print("compare_runs selftest OK: identical PASS, seeded drift + "
          "injected NaN detected")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch compare",
        description="Diff two runs' artifacts into one regression verdict")
    ap.add_argument("run_a", nargs="?", help="baseline run output root")
    ap.add_argument("run_b", nargs="?", help="candidate run output root")
    ap.add_argument("--atol", type=float, default=1e-2,
                    help="absolute tolerance on digest stats (default "
                         "1e-2, the value tier's band)")
    ap.add_argument("--rtol", type=float, default=0.02,
                    help="relative tolerance on digest stats")
    ap.add_argument("--stage-band", type=float, default=0.5,
                    help="allowed fractional ms/call growth per stage "
                         "(0.5 = 1.5x) before it counts as a regression")
    ap.add_argument("--min-stage-s", type=float, default=0.5,
                    help="ignore stages whose total is under this many "
                         "seconds on both sides (noise floor)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-drift fixture and exit")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.run_a or not args.run_b:
        ap.error("run_a and run_b are required (or use --selftest)")
    for d in (args.run_a, args.run_b):
        if not os.path.isdir(d):
            print(f"error: {d} is not a directory", file=sys.stderr)
            return 2
    rc, lines = compare(args.run_a, args.run_b, atol=args.atol,
                        rtol=args.rtol, stage_band=args.stage_band,
                        min_stage_s=args.min_stage_s)
    print("\n".join(lines))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
