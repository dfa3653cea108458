"""Output health: per-(video, family, key) feature digests at the sink
boundary (port of ``video_features_tpu/telemetry/health.py``).

With ``health=true`` every feature tensor that reaches the sink gets a
digest (shape and dtype, NaN/Inf counts, finite min/max/mean/std, L2 norm,
and a quantization-tolerant content signature) appended to
``{output_path}/_health.jsonl``, one record per (video, family, output key)
in the shape ``feature_health.schema.json`` freezes (a copy of the JAX
package's). A non-finite feature is never written: it raises
:class:`NonFiniteFeatureError`, which ``utils/faults.py`` classifies POISON,
so the video goes through the retries, the journal and the quarantine.
With a recorder live, each digest is also a ``health`` event on the span,
the ``vft_health_nonfinite_total{family}`` counter and the manifest's
per-family roll-up.

:func:`content_signature` and :data:`SIG_GRID` are the digest's signature
and the one the feature cache (``cache.py``) stores and re-verifies.
"""
from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .jsonl import append_jsonl

#: schema identifier stamped into every record; bump on breaking change
SCHEMA_VERSION = "vft.feature_health/1"

HEALTH_FILENAME = "_health.jsonl"

HEALTH_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                                  "feature_health.schema.json")

#: exactly the top-level keys of every emitted record, in emit order; the
#: JSON Schema's properties, and the JAX package's tuple, are these
HEALTH_FIELDS = (
    "schema", "video", "feature_type", "request_id", "key", "shape",
    "dtype", "elems", "nan", "inf", "min", "max", "mean", "std", "l2",
    "sig", "time",
)

#: content-signature quantization grid: values are snapped to multiples
#: of SIG_GRID before hashing, chosen at half the value tier's atol=1e-2
#: so two runs whose features differ only by sub-tolerance noise hash
#: identically (unless a value straddles a bucket edge — the signature
#: is a fast-path equality check; compare_runs' stat tolerance bands are
#: the authoritative drift measure)
SIG_GRID = 5e-3


def content_signature(arr: np.ndarray) -> str:
    """Quantization-tolerant sha256 of a feature tensor.

    Values snap to the :data:`SIG_GRID` lattice (float64 accumulate) and
    the integer bucket indices are hashed together with the shape, so
    the signature survives benign noise (bf16 rounding jitter well under
    tolerance) but changes when content genuinely moves. NaN/Inf map to
    dedicated sentinel buckets, so a non-finite value also changes it.
    """
    a = np.asarray(arr)
    if a.dtype == object:
        # pickled object features (no numeric lattice): hash the repr
        return hashlib.sha256(repr(a.tolist()).encode()).hexdigest()
    q = np.round(a.astype(np.float64) / SIG_GRID)
    # sentinel buckets far outside any real feature's range; int64-safe
    q = np.nan_to_num(q, nan=2.0 ** 52, posinf=2.0 ** 53, neginf=-2.0 ** 53)
    q = np.clip(q, -(2.0 ** 53), 2.0 ** 53)
    h = hashlib.sha256(repr(a.shape).encode())
    h.update(q.astype(np.int64).tobytes())
    return h.hexdigest()


def digest_array(key: str, value: Any, *, video: str,
                 feature_type: Optional[str]) -> dict:
    """One feature tensor -> one schema-shaped digest record.

    Cost is a handful of O(n) numpy reductions plus one sha256 pass.
    """
    a = np.asarray(value)
    if a.dtype == object or a.size == 0:
        finite = np.zeros(0)
        nan = inf = 0
    else:
        f = a.astype(np.float64, copy=False)
        finite_mask = np.isfinite(f)
        nan = int(np.isnan(f).sum())
        inf = int(a.size - finite_mask.sum() - nan)
        finite = f[finite_mask] if nan or inf else f
    stats = {"min": None, "max": None, "mean": None, "std": None, "l2": None}
    if finite.size:
        stats = {
            "min": float(finite.min()),
            "max": float(finite.max()),
            "mean": float(finite.mean()),
            "std": float(finite.std()),
            "l2": float(np.sqrt(np.square(finite).sum())),
        }
    from .context import current_request_id
    return {
        "schema": SCHEMA_VERSION,
        "video": str(video),
        "feature_type": feature_type,
        # request correlation (telemetry/context.py): null in batch runs
        "request_id": current_request_id(),
        "key": str(key),
        "shape": [int(s) for s in a.shape],
        "dtype": str(a.dtype),
        "elems": int(a.size),
        "nan": nan,
        "inf": inf,
        "min": stats["min"],
        "max": stats["max"],
        "mean": stats["mean"],
        "std": stats["std"],
        "l2": stats["l2"],
        "sig": content_signature(a),
        "time": round(time.time(), 3),
    }


def digest_features(feats: Dict[str, Any], video: str,
                    feature_type: Optional[str],
                    output_path: Optional[str]) -> List[dict]:
    """Digest every output key of one (video, family) extraction.

    Appends each record to ``{output_path}/_health.jsonl`` (atomic
    O_APPEND, telemetry/jsonl.py) and, when telemetry is live, attaches
    a ``health`` event to the current span, bumps
    ``vft_health_nonfinite_total{family}`` for non-finite tensors and
    feeds the recorder's manifest roll-up. Works with telemetry off too:
    the JSONL artifact alone is what compare_runs consumes.
    """
    from .. import telemetry

    recs = []
    path = (os.path.join(str(output_path), HEALTH_FILENAME)
            if output_path else None)
    for key, value in feats.items():
        rec = digest_array(key, value, video=video,
                           feature_type=feature_type)
        if path is not None:
            append_jsonl(path, rec)
        nonfinite = rec["nan"] + rec["inf"]
        telemetry.event("health", key=rec["key"], nan=rec["nan"],
                        inf=rec["inf"], sig=rec["sig"])
        if nonfinite:
            telemetry.inc("vft_health_nonfinite_total", nonfinite,
                          family=str(feature_type))
        r = telemetry.active()
        if r is not None:
            r.health_observe(rec)
        recs.append(rec)
    return recs


def check_features(feats: Dict[str, Any], video: str,
                   feature_type: Optional[str],
                   output_path: Optional[str]) -> List[dict]:
    """Digest + gate: raise :class:`NonFiniteFeatureError` when any
    output tensor carries NaN/Inf, AFTER the digests are journaled (the
    ``_health.jsonl`` record of the bad tensor is exactly what the
    operator diagnoses with). ``utils/faults.py`` classifies the raise
    POISON: bounded retries, then quarantine — never a silent write."""
    recs = digest_features(feats, video, feature_type, output_path)
    bad = [(r["key"], r["nan"], r["inf"]) for r in recs
           if r["nan"] or r["inf"]]
    if bad:
        detail = ", ".join(f"{k}: {n} NaN / {i} Inf" for k, n, i in bad)
        raise NonFiniteFeatureError(
            f"non-finite feature values for {video} ({detail}) — refusing "
            "to write; see _health.jsonl (health=false disables this gate)")
    return recs


class NonFiniteFeatureError(Exception):
    """A computed feature contains NaN/Inf. Classified POISON by
    ``utils/faults.py`` (by name, so the worker-forwarded string form
    also classifies): the input/feature pair is bad in a way retries
    rarely fix, and the quarantine journal is the right destination."""


def load_health_schema() -> dict:
    import json
    with open(HEALTH_SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def validate_health(rec: dict) -> List[str]:
    """Violations of the checked-in schema (telemetry/schema.py
    dependency-free validator); empty list == valid."""
    from . import schema as tschema
    return tschema.validate(rec, load_health_schema())
