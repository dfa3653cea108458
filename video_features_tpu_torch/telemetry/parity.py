"""Per-seam numerics observatory (port of
``video_features_tpu/telemetry/parity.py``).

The health pillar (``telemetry/health.py``) digests features at the sink
only: a drift introduced at decode, transform or backbone shows only once
it breaks the end-to-end band, with no attribution. ``parity=true`` taps
the four pipeline seams

    decoded frames -> transformed tensors -> backbone activations
    -> head features

and appends one digest per (video, seam, key, index) to
``{output_path}/_parity.jsonl`` (``parity.schema.json``, a copy of the JAX
package's), on ``telemetry/health.py digest_array``: finite stats plus the
content signature on the 5e-3 lattice. Every tap digests a host array the
path already has (a decoded or transformed frame, a result the stream has
copied off the card, a feature at the sink): the observatory adds no
device-to-host copy and no synchronize.

Off by default: with ``parity=false`` the transform wrapper is never
installed (``extractors/base.py`` gates on one attribute), every other tap
is one attribute read, and no artifact appears.

**Certification**:

    python -m video_features_tpu_torch parity certify --family raft \
        --flip dtype=bf16 --set device=cuda

runs a reference arm and a candidate arm in process over a pinned corpus
(the vendored sample by default), captures every seam in memory and writes
``_parity_verdict.json`` (``parity_verdict.schema.json``) with per-seam
error attribution (max and mean abs, max rel, min cosine) against the
per-(family, seam) :data:`TOLERANCES`; a FAIL names the first seam that
drifted. Both arms are torch arms of this package: the reference pinned to
``precision=float32``, the candidate with the flip. Between the arms the
precision latch (``device.py set_precision``: TF32 off for convolutions and
matmuls) is reset to PyTorch's defaults, as JAX's certify resets
``jax_default_matmul_precision``, so neither arm inherits the other's.
The comparison of this package with the JAX package is the tests' work
(``tests/test_torch_*.py``), not certify's.

Spawned decode children (``video_decode=process|parallel``) carry no
observer global, so the transform tap is a pure pass-through there: seam
records come from in-process decode paths (the default inline decode, the
shared decode of a multi-family run, and certify).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .jsonl import append_jsonl, write_json_atomic

#: schema identifiers stamped into every record; bump on breaking change
SCHEMA_VERSION = "vft.parity/1"
#: the certify verdict artifact's version tag (second schema of this
#: emitter module — the loadgen journal/scenario pattern)
VERDICT_SCHEMA = "vft.parity_verdict/1"

PARITY_FILENAME = "_parity.jsonl"
VERDICT_FILENAME = "_parity_verdict.json"

PARITY_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                                  "parity.schema.json")
VERDICT_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                                   "parity_verdict.schema.json")

#: the four seams, in pipeline order — FAIL attribution reports the
#: FIRST seam (in this order) whose error leaves its tolerance band
SEAMS = ("decode", "transform", "backbone", "head")

VERDICTS = ("PASS", "FAIL")

#: exactly the top-level keys of every emitted record, in emit order,
#: equal to parity.schema.json's properties
PARITY_FIELDS = (
    "schema", "video", "feature_type", "request_id", "seam", "key",
    "index", "shape", "dtype", "elems", "nan", "inf", "min", "max",
    "mean", "std", "l2", "sig", "time",
)

#: top-level keys of the certify verdict artifact (emit order), equal to
#: parity_verdict.schema.json's properties
VERDICT_FIELDS = (
    "schema", "family", "host", "flip", "ref", "cand", "corpus",
    "seams", "first_drift", "verdict", "time",
)

#: per-(family, seam) tolerance bands for certify. ``"*"`` is the
#: default family. Every entry carries its written justification — the
#: band is an argued contract, not a magic number. Gating metrics:
#: ``max_abs`` (absolute error ceiling over every captured pair) and
#: ``cos`` (minimum cosine similarity floor). ``mean_abs``/``max_rel``
#: are recorded in the verdict for diagnosis but do not gate: near-zero
#: activations make relative error unboundedly noisy.
TOLERANCES: Dict[Tuple[str, str], Dict[str, Any]] = {
    ("*", "decode"): {
        "max_abs": 1e-6, "cos": 1.0 - 1e-9,
        "why": "decode is uint8 cv2 output on the host; a numerics flip "
               "cannot legally touch it — any drift here means the flip "
               "leaked upstream of the device (or the corpus moved)."},
    ("*", "transform"): {
        "max_abs": 1e-6, "cos": 1.0 - 1e-9,
        "why": "host transforms (PIL resize/crop/normalize) run in "
               "float32 regardless of device precision; exact equality "
               "modulo float32 associativity noise is the contract."},
    ("*", "backbone"): {
        "max_abs": 0.5, "cos": 0.99,
        "why": "bf16 keeps 8 mantissa bits (~0.4% per-element rounding); "
               "conv stacks accumulate it but direction is preserved — "
               "cos>=0.99 is the migration-parity bar the TF->JAX papers "
               "certify components at, max_abs bounds the outliers."},
    ("*", "head"): {
        "max_abs": 0.5, "cos": 0.99,
        "why": "head features inherit backbone drift; same bf16 rounding "
               "argument, measured against the 5e-3 signature lattice "
               "the value tier already grants (atol=1e-2)."},
    ("raft", "backbone"): {
        "max_abs": 2.0, "cos": 0.98,
        "why": "RAFT's iterative refinement re-feeds its own flow "
               "estimate 12x, compounding bf16 rounding; flow is in "
               "pixel units and ToUInt8 sinks absorb <1px drift (RAFT "
               "paper, arxiv 2003.12039) — 2px absolute headroom with "
               "direction pinned at cos>=0.98."},
    ("raft", "head"): {
        "max_abs": 2.0, "cos": 0.98,
        "why": "head == transposed backbone flow for OpticalFlow "
               "families; same band as the backbone seam."},
    ("pwc", "backbone"): {
        "max_abs": 2.0, "cos": 0.98,
        "why": "PWC's cost-volume warping cascade amplifies small input "
               "deltas across pyramid levels like RAFT's refinement "
               "loop; same pixel-unit argument and band."},
    ("pwc", "head"): {
        "max_abs": 2.0, "cos": 0.98,
        "why": "head == transposed backbone flow; same band as the "
               "backbone seam."},
}


def tolerance_for(family: str, seam: str) -> Dict[str, Any]:
    """The registry band for (family, seam), falling back to the
    ``"*"`` default for the seam."""
    band = TOLERANCES.get((str(family), seam))
    if band is None:
        band = TOLERANCES[("*", seam)]
    return band


def validate_tolerances() -> List[str]:
    """Registry self-check (tests pin it): every entry names a known
    seam, carries numeric ``max_abs``/``cos`` bounds and a non-empty
    written justification, and every seam has a ``"*"`` default."""
    errs: List[str] = []
    for (fam, seam), band in TOLERANCES.items():
        where = f"TOLERANCES[({fam!r}, {seam!r})]"
        if seam not in SEAMS:
            errs.append(f"{where}: unknown seam (SEAMS={list(SEAMS)})")
        for k in ("max_abs", "cos"):
            v = band.get(k)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errs.append(f"{where}: {k}={v!r} is not a number")
        why = band.get("why")
        if not isinstance(why, str) or len(why.strip()) < 20:
            errs.append(f"{where}: missing a written justification "
                        "('why' must argue the band)")
    for seam in SEAMS:
        if ("*", seam) not in TOLERANCES:
            errs.append(f"TOLERANCES: no ('*', {seam!r}) default")
    return errs


# -- the observer ------------------------------------------------------------

#: frames/batches recorded per (video, seam, key): enough to prove
#: bit-stability and attribute drift, bounded so parity=true on a long
#: corpus stays a rounding error next to decode+forward
MAX_PER_KEY = 4
#: certify captures a little deeper — the corpus is pinned and tiny
CERTIFY_PER_KEY = 8


class ParityObserver:
    """Seam-digest recorder. One per run (``cli.py`` lifecycle), installed
    as the module global via :func:`_set_active` — the taps read one
    global and no-op when it is None.

    ``capture=True`` (certify) stores bounded float64 copies of every
    tapped tensor in memory instead of journaling digests.

    ``perturb={seam: eps}`` adds ``eps`` to the *tapped copy* at that
    seam before digest/capture — the pipeline itself is untouched. It
    exists to drill the certify attribution path (tests, ``chip_smoke.py``):
    an injected drift must FAIL at exactly the perturbed seam.
    """

    def __init__(self, out_root: Optional[str], host_id: Optional[str] = None,
                 max_per_key: int = MAX_PER_KEY, capture: bool = False,
                 perturb: Optional[Dict[str, float]] = None):
        self.out_root = str(out_root) if out_root is not None else None
        # workers that share out_root each append their own
        # _parity_{host_id}.jsonl (single-writer dirs keep _parity.jsonl)
        fname = (PARITY_FILENAME if not host_id
                 else f"_parity_{host_id}.jsonl")
        self.path = (os.path.join(self.out_root, fname)
                     if self.out_root is not None else None)
        self.host_id = host_id
        self.max_per_key = int(max_per_key)
        self.perturb = dict(perturb or {})
        #: (video, family, seam, key) -> records emitted (bounds the
        #: journal per family — multi-family runs share one video path)
        self._counts: Dict[Tuple[str, str, str, str], int] = {}
        self._seam_totals: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: capture mode: (video, seam, key, index) -> float64 ndarray
        self.captured: Optional[Dict[Tuple[str, str, str, int],
                                     np.ndarray]] = {} if capture else None
        self._write_failed = False
        self._closed = False

    def observe(self, seam: str, key: str, value: Any, *, video: str,
                feature_type: Optional[str], index: int) -> None:
        """Digest one tensor at one seam; bounded per (video, seam,
        key). Thread-safe: families tap concurrently under
        video_workers>1 / shared decode."""
        if self._closed or seam not in SEAMS:
            return
        ck = (str(video), str(feature_type), seam, str(key))
        with self._lock:
            n = self._counts.get(ck, 0)
            if n >= self.max_per_key:
                return
            self._counts[ck] = n + 1
            self._seam_totals[seam] = self._seam_totals.get(seam, 0) + 1
        a = np.asarray(value)
        eps = self.perturb.get(seam)
        if eps:
            a = a.astype(np.float64, copy=True) + float(eps)
        if self.captured is not None:
            self.captured[(str(video), seam, str(key), int(index))] = \
                np.asarray(a, dtype=np.float64).copy()
            return
        rec = digest_seam(seam, key, a, video=video,
                          feature_type=feature_type, index=index)
        if self.path is not None and not self._write_failed:
            try:
                append_jsonl(self.path, rec)
            except OSError as e:
                # a full disk never kills extraction for a diagnostic:
                # latch, name it once, count it
                self._write_failed = True
                print(f"parity: disabling {PARITY_FILENAME} appends "
                      f"after write failure: {type(e).__name__}: {e}")
                from .. import telemetry
                telemetry.inc("vft_telemetry_write_failures_total",
                              pillar="parity")
        from .. import telemetry
        telemetry.inc("vft_parity_records_total",
                      family=str(feature_type), seam=seam)

    def snapshot(self) -> dict:
        """Light heartbeat section: per-seam record tallies (recorder
        ``parity_snapshot`` reads this through the module global)."""
        with self._lock:
            per_seam = dict(self._seam_totals)
        return {"records": sum(per_seam.values()), "seams": per_seam,
                "write_failed": self._write_failed} if per_seam or \
            self._write_failed else {"records": 0, "seams": {},
                                     "write_failed": False}

    def close(self) -> None:
        """Idempotent; appends are already durable (O_APPEND)."""
        self._closed = True


# -- the one-global-read off path --------------------------------------------

_active: Optional[ParityObserver] = None


def _set_active(obs: Optional[ParityObserver]) -> None:
    global _active
    _active = obs


def active() -> Optional[ParityObserver]:
    return _active


def snapshot() -> dict:
    """The active observer's heartbeat section; ``{}`` when off — the
    off-path heartbeat stays constant (roofline discipline)."""
    r = _active
    return r.snapshot() if r is not None else {}


def tap(seam: str, key: str, value: Any, *, video: str,
        feature_type: Optional[str], index: int = 0) -> None:
    """Record one tensor at one seam; one global read when off.

    Call sites additionally gate on the extractor's ``self.parity``
    attribute (like health), so a multi-family run records only the
    families that asked."""
    r = _active
    if r is not None:
        r.observe(seam, key, value, video=video,
                  feature_type=feature_type, index=index)


class TransformTap:
    """Picklable transform wrapper covering the decode and transform
    seams in one callable.

    Installed by ``extractors/base.py video_source()`` around the
    family's host transform (only when ``parity=true``), BEFORE the
    shared-decode subscribe — so shared and private decode paths tap
    identically on the family's own thread. Frames arrive sequentially
    per source, so the plain index counter is deterministic. In a
    spawned decode child the module global is unset and the tap is a
    pure pass-through of the inner transform.
    """

    def __init__(self, inner: Optional[Callable], video: str,
                 feature_type: Optional[str]):
        self.inner = inner
        self.video = str(video)
        self.feature_type = feature_type
        self._idx = 0

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        r = _active
        if r is None:
            return self.inner(frame) if self.inner is not None else frame
        idx = self._idx
        self._idx = idx + 1
        r.observe("decode", "frame", frame, video=self.video,
                  feature_type=self.feature_type, index=idx)
        out = self.inner(frame) if self.inner is not None else frame
        r.observe("transform", "frame", out, video=self.video,
                  feature_type=self.feature_type, index=idx)
        return out


# -- digests -----------------------------------------------------------------

def digest_seam(seam: str, key: str, value: Any, *, video: str,
                feature_type: Optional[str], index: int) -> dict:
    """One seam tensor -> one PARITY_FIELDS-shaped record, reusing the
    health pillar's digest machinery (finite stats + the 5e-3-lattice
    content signature)."""
    from . import health
    base = health.digest_array(key, value, video=video,
                               feature_type=feature_type)
    return {
        "schema": SCHEMA_VERSION,
        "video": base["video"],
        "feature_type": base["feature_type"],
        "request_id": base["request_id"],
        "seam": str(seam),
        "key": base["key"],
        "index": int(index),
        "shape": base["shape"],
        "dtype": base["dtype"],
        "elems": base["elems"],
        "nan": base["nan"],
        "inf": base["inf"],
        "min": base["min"],
        "max": base["max"],
        "mean": base["mean"],
        "std": base["std"],
        "l2": base["l2"],
        "sig": base["sig"],
        "time": base["time"],
    }


def load_parity_schema() -> dict:
    with open(PARITY_SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def load_verdict_schema() -> dict:
    with open(VERDICT_SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def validate_parity(rec: dict) -> List[str]:
    from . import schema as tschema
    return tschema.validate(rec, load_parity_schema())


def validate_verdict(doc: dict) -> List[str]:
    from . import schema as tschema
    return tschema.validate(doc, load_verdict_schema())


def collect_verdicts(root: str) -> List[dict]:
    """Every ``_parity_verdict*.json`` under ``root`` (time-ordered),
    skipping frozen incident-bundle snapshots (``_incidents``)."""
    out: List[dict] = []
    for p in sorted(Path(root).rglob(VERDICT_FILENAME[:-5] + "*.json")):
        if "_incidents" in p.parts:
            continue
        try:
            doc = json.loads(p.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        if isinstance(doc, dict) and str(doc.get("schema", "")).startswith(
                "vft.parity_verdict/"):
            out.append(doc)
    out.sort(key=lambda d: float(d.get("time") or 0.0))
    return out


# -- certify: reference arm vs candidate arm ---------------------------------

def _normalize_flip(flip: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``--flip key=value`` -> (ref_overrides, cand_overrides).

    ``dtype=bf16`` is the first-class spelling: candidate runs
    ``precision=bfloat16`` against a pinned ``precision=float32``
    reference — regardless of what the YAML default currently says, so
    a certify re-run stays meaningful AFTER the default flips.
    """
    if "=" not in flip:
        raise SystemExit(f"--flip {flip!r}: expected key=value")
    key, val = flip.split("=", 1)
    key, val = key.strip(), val.strip()
    if key in ("dtype", "precision"):
        cand = {"bf16": "bfloat16", "bfloat16": "bfloat16",
                "f32": "float32", "float32": "float32"}.get(val)
        if cand is None:
            raise SystemExit(f"--flip {flip!r}: dtype must be bf16 or "
                             "float32")
        return {"precision": "float32"}, {"precision": cand}
    # generic flip: candidate override only, reference = YAML default
    return {}, {key: val}


def _pair_metrics(pairs: List[Tuple[np.ndarray, np.ndarray]]) -> dict:
    """Error attribution over aligned (ref, cand) tensor pairs."""
    max_abs = mean_num = 0.0
    mean_den = 0
    max_rel = 0.0
    cos_min = 1.0
    for r, c in pairs:
        d = np.abs(r - c)
        if d.size:
            max_abs = max(max_abs, float(d.max()))
            mean_num += float(d.sum())
            mean_den += d.size
            max_rel = max(max_rel, float(
                (d / (np.abs(r) + 1e-8)).max()))
        rn = float(np.sqrt(np.square(r).sum()))
        cn = float(np.sqrt(np.square(c).sum()))
        if rn == 0.0 and cn == 0.0:
            cos = 1.0
        elif rn == 0.0 or cn == 0.0:
            cos = 0.0
        else:
            cos = float(np.dot(r.ravel(), c.ravel()) / (rn * cn))
        cos_min = min(cos_min, cos)
    return {"pairs": len(pairs),
            "max_abs": round(max_abs, 9),
            "mean_abs": round(mean_num / mean_den, 9) if mean_den else 0.0,
            "max_rel": round(max_rel, 9),
            "cos": round(cos_min, 9)}


def compare_captures(ref: Dict[Tuple[str, str, str, int], np.ndarray],
                     cand: Dict[Tuple[str, str, str, int], np.ndarray],
                     family: str) -> Tuple[dict, Optional[str], str]:
    """(per-seam verdict table, first drifted seam or None, PASS/FAIL).

    Seams evaluate in pipeline order; a FAIL names the FIRST one out of
    band — that is the attribution the observatory exists for."""
    seams: Dict[str, dict] = {}
    first: Optional[str] = None
    for seam in SEAMS:
        rkeys = {k for k in ref if k[1] == seam}
        ckeys = {k for k in cand if k[1] == seam}
        shared = sorted(rkeys & ckeys)
        band = tolerance_for(family, seam)
        note = None
        pairs: List[Tuple[np.ndarray, np.ndarray]] = []
        for k in shared:
            a, b = ref[k], cand[k]
            if a.shape != b.shape:
                note = (f"shape drift at {k[2]}#{k[3]}: "
                        f"{list(a.shape)} vs {list(b.shape)}")
                break
            pairs.append((a, b))
        if note is None and rkeys != ckeys:
            miss = sorted(rkeys ^ ckeys)[:3]
            note = (f"record-set drift: {len(rkeys)} ref vs {len(ckeys)} "
                    f"cand captures (e.g. {[f'{m[2]}#{m[3]}' for m in miss]})")
        m = _pair_metrics(pairs)
        ok = (note is None and m["pairs"] > 0
              and m["max_abs"] <= float(band["max_abs"])
              and m["cos"] >= float(band["cos"]))
        if note is None and m["pairs"] == 0:
            note = "no captures at this seam"
        m.update(tol_max_abs=float(band["max_abs"]),
                 tol_cos=float(band["cos"]), why=band["why"],
                 ok=bool(ok), note=note)
        seams[seam] = m
        if not ok and first is None:
            first = seam
    return seams, first, ("PASS" if first is None else "FAIL")


def _reset_precision_latch() -> None:
    """PyTorch's own defaults for the flags ``device.py set_precision``
    latches: TF32 convolutions on, TF32 matmuls off."""
    import torch
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def _certify_arm(family: str, overrides: Dict[str, Any],
                 videos: List[str], perturb: Optional[Dict[str, float]],
                 label: str) -> Dict[Tuple[str, str, str, int], np.ndarray]:
    """Run one arm in-process with an in-memory capture observer."""
    import torch

    from ..config import load_config, sanity_check
    from ..registry import get_extractor_cls

    obs = ParityObserver(out_root=None, capture=True,
                         max_per_key=CERTIFY_PER_KEY, perturb=perturb)
    prev = _active
    latch = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    _set_active(obs)
    try:
        # the extractor latches full float32 (device.py set_precision);
        # each arm starts from PyTorch's defaults, so the candidate never
        # inherits the reference's latch
        _reset_precision_latch()
        args = load_config(family, dict(overrides))
        sanity_check(args)
        print(f"parity certify: {label} arm "
              f"({ {k: overrides[k] for k in sorted(overrides) if k in ('precision',)} or 'yaml defaults'})",
              file=sys.stderr)
        ex = get_extractor_cls(family)(args)
        for v in videos:
            feats = ex.extract(str(v))
            for key, val in feats.items():
                obs.observe("head", key, val, video=str(v),
                            feature_type=family, index=0)
    finally:
        _set_active(prev)
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = latch
        obs.close()
    return obs.captured or {}


def _default_corpus() -> List[str]:
    sample = (Path(__file__).resolve().parents[2] / "tests" / "assets"
              / "v_synth_sample.mp4")
    return [str(sample)] if sample.exists() else []


def _file_sha(path: str) -> Optional[str]:
    import hashlib
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def certify(family: str, flip: Optional[str] = None,
            videos: Optional[List[str]] = None,
            frames: int = 6, out_dir: Optional[str] = None,
            perturb: Optional[Dict[str, float]] = None,
            extra_overrides: Optional[Dict[str, Any]] = None) -> dict:
    """A/B certification engine; returns the verdict document (also
    written atomically to ``{out_dir}/_parity_verdict.json``)."""
    import socket
    import tempfile

    videos = list(videos or _default_corpus())
    if not videos:
        raise SystemExit("parity certify: no corpus — pass --videos or "
                         "vendor tests/assets/v_synth_sample.mp4")
    ref_flip, cand_flip = _normalize_flip(flip) if flip else ({}, {})
    with tempfile.TemporaryDirectory(prefix="vft_parity_") as td:
        base = {
            "parity": True, "cache": False, "telemetry": False,
            "allow_random_weights": True, "on_extraction": "print",
            "retry_attempts": 1, "batch_size": 4,
            "extraction_total": int(frames),
            "video_paths": list(videos),
            "output_path": os.path.join(td, "out"),
            "tmp_path": os.path.join(td, "tmp"),
        }
        base.update(extra_overrides or {})
        ref_caps = _certify_arm(family, dict(base, **ref_flip), videos,
                                None, "reference")
        cand_caps = _certify_arm(family, dict(base, **cand_flip), videos,
                                 perturb, "candidate")
    seams, first, verdict = compare_captures(ref_caps, cand_caps, family)
    doc = {
        "schema": VERDICT_SCHEMA,
        "family": str(family),
        "host": socket.gethostname(),
        "flip": flip,
        "ref": {k: str(v) for k, v in sorted(ref_flip.items())},
        "cand": {k: str(v) for k, v in sorted(cand_flip.items())},
        "corpus": [{"video": os.path.basename(v), "sha256": _file_sha(v)}
                   for v in videos],
        "seams": seams,
        "first_drift": first,
        "verdict": verdict,
        "time": round(time.time(), 3),
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        write_json_atomic(os.path.join(out_dir, VERDICT_FILENAME), doc)
    return doc


def render_verdict(doc: dict) -> List[str]:
    lines = [f"== parity verdict: {doc.get('family')} "
             f"[{doc.get('verdict')}] =="
             + (f" flip={doc.get('flip')}" if doc.get("flip") else "")]
    for seam in SEAMS:
        m = (doc.get("seams") or {}).get(seam)
        if not m:
            continue
        mark = "ok " if m.get("ok") else "DRIFT"
        lines.append(
            f"  {mark} {seam:9s} pairs={m.get('pairs'):3d} "
            f"max_abs={m.get('max_abs'):.3g}/{m.get('tol_max_abs'):.3g} "
            f"mean_abs={m.get('mean_abs'):.3g} "
            f"cos={m.get('cos'):.6f}>={m.get('tol_cos')}"
            + (f"  [{m['note']}]" if m.get("note") else ""))
    if doc.get("first_drift"):
        lines.append(f"  first drifted seam: {doc['first_drift']} — "
                     "upstream seams are clean; the drift enters here")
    return lines


def certify_main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch parity certify",
        description="A/B-certify a numerics flip with per-seam error "
                    "attribution")
    p.add_argument("--config", help="family YAML name, e.g. raft.yml")
    p.add_argument("--family", help="family name (alternative to --config)")
    p.add_argument("--flip", default=None,
                   help="candidate-arm flip, e.g. dtype=bf16 "
                        "(omit for an identity A/B harness check)")
    p.add_argument("--videos", default=None,
                   help="comma-separated pinned corpus (default: the "
                        "vendored synth sample)")
    p.add_argument("--frames", type=int, default=6,
                   help="extraction_total per arm (default 6)")
    p.add_argument("--out", default=".",
                   help="directory for _parity_verdict.json")
    p.add_argument("--perturb", action="append", default=[],
                   metavar="SEAM=EPS",
                   help="drill knob: add EPS to the candidate arm's "
                        "tapped copies at SEAM (attribution must name it)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="extra config override for BOTH arms")
    a = p.parse_args(argv)
    family = a.family or (Path(a.config).stem if a.config else None)
    if not family:
        p.error("one of --config / --family is required")
    perturb: Dict[str, float] = {}
    for spec in a.perturb:
        seam, _, eps = spec.partition("=")
        if seam not in SEAMS:
            p.error(f"--perturb {spec!r}: seam must be one of {list(SEAMS)}")
        perturb[seam] = float(eps)
    extra: Dict[str, Any] = {}
    for spec in a.set:
        import yaml
        k, _, v = spec.partition("=")
        try:
            extra[k] = yaml.safe_load(v) if v != "" else None
        except yaml.YAMLError:
            extra[k] = v
    videos = [v for v in (a.videos or "").split(",") if v] or None
    doc = certify(family, flip=a.flip, videos=videos, frames=a.frames,
                  out_dir=a.out, perturb=perturb or None,
                  extra_overrides=extra or None)
    print("\n".join(render_verdict(doc)))
    print(f"verdict -> {os.path.join(a.out, VERDICT_FILENAME)}")
    return 0 if doc["verdict"] == "PASS" else 1


def report_main(argv: Optional[List[str]] = None) -> int:
    """``python -m video_features_tpu_torch parity <run_dir>``: summarize
    (and optionally gate on) a run's ``_parity.jsonl``."""
    import argparse
    from .jsonl import read_jsonl
    p = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch parity",
        description="Per-seam numerics observatory: summarize a run's "
                    "_parity.jsonl, or `parity certify` a flip")
    p.add_argument("run_dir")
    p.add_argument("--validate", action="store_true",
                   help="exit 1 when any record violates the schema")
    a = p.parse_args(argv)
    # single-writer dirs keep _parity.jsonl; workers sharing a dir write
    # per-host _parity_{host_id}.jsonl: summarize whichever exist
    paths = sorted(Path(a.run_dir).glob("_parity*.jsonl"))
    if not paths:
        print(f"no {PARITY_FILENAME} under {a.run_dir} (parity=false?)")
        return 1 if a.validate else 0
    tallies: Dict[Tuple[str, str], int] = {}
    violations = 0
    for path in paths:
        for rec in read_jsonl(path):
            errs = validate_parity(rec)
            if errs:
                violations += 1
                for e in errs[:3]:
                    print(f"  INVALID: {e}")
            k = (str(rec.get("feature_type")), str(rec.get("seam")))
            tallies[k] = tallies.get(k, 0) + 1
    print(f"== parity records: {', '.join(str(p) for p in paths)} ==")
    for (fam, seam) in sorted(tallies):
        print(f"  {fam:12s} {seam:9s} {tallies[(fam, seam)]:5d}")
    verds = collect_verdicts(a.run_dir)
    for doc in verds:
        print("\n".join(render_verdict(doc)))
    if violations:
        print(f"{violations} schema-invalid record(s)")
    return 1 if (a.validate and violations) else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "certify":
        return certify_main(argv[1:])
    return report_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
