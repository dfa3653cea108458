"""The port's run-invariant auditor (``video_features_tpu_torch/audit.py``)
against the JAX package's ``video_features_tpu/audit.py``.

Each fault case of the JAX ``tests/test_audit.py`` (one targeted mutation
of a consistent, fully cross-linked output tree built with the port's own
writers), plus cases of the spool, gc-journal and drill-verdict
invariants: on the same tree the port's ``audit_run`` gives JAX's
``(ok, violations, notes)``, word for word, and the verdict each case is
built to produce. The CLI (``python -m video_features_tpu_torch audit``)
exits 0 on PASS and 1 on FAIL.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu.audit import audit_run as jaudit_run
from video_features_tpu_torch import gc as tgc
from video_features_tpu_torch.audit import SCENARIO_SCHEMA
from video_features_tpu_torch.audit import audit_run as taudit_run
from video_features_tpu_torch.telemetry.health import digest_array
from video_features_tpu_torch.telemetry.jsonl import append_jsonl


def _hash(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def _mk_consistent_run(root: Path) -> Path:
    """One video's artifact with its health digest, artifact span and
    queue done marker, an explained error, a quarantined item with its
    POISON record, and a final heartbeat (JAX ``tests/test_audit.py``)."""
    root.mkdir(parents=True, exist_ok=True)
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.save(root / "v0_resnet.npy", arr)
    data = (root / "v0_resnet.npy").read_bytes()
    append_jsonl(root / "_health.jsonl",
                 digest_array("resnet", arr, video="v0.mp4",
                              feature_type="resnet"))
    append_jsonl(root / "_telemetry.jsonl", {
        "schema": "vft.video_span/1", "video": "v0.mp4", "status": "done",
        "events": [{"kind": "artifact", "key": "resnet",
                    "file": "v0_resnet.npy", "bytes": len(data),
                    "sha256": _hash(data)}],
    })
    q = root / "_queue"
    for d in ("pending", "done", "quarantined", ".staging"):
        (q / d).mkdir(parents=True, exist_ok=True)
    (q / "claimed" / "hostA").mkdir(parents=True, exist_ok=True)
    (q / "done" / "v0-aaaa.json").write_text(json.dumps(
        {"id": "v0-aaaa", "video": "v0.mp4", "status": "done",
         "by": "hostA"}))
    (q / "done" / "v1-bbbb.json").write_text(json.dumps(
        {"id": "v1-bbbb", "video": "v1.mp4", "status": "error",
         "by": "hostA"}))
    (q / "quarantined" / "v2-cccc.json").write_text(json.dumps(
        {"id": "v2-cccc", "video": "v2.mp4", "reclaims": 4}))
    append_jsonl(root / "_failures.jsonl",
                 {"video": "v1.mp4", "category": "FATAL", "attempts": 1,
                  "error": "ValueError: boom"})
    append_jsonl(root / "_failures.jsonl",
                 {"video": "v2.mp4", "category": "POISON", "attempts": 3,
                  "error": "fleet: reclaimed 4x"})
    (root / "_heartbeat_hostA.json").write_text(json.dumps(
        {"host_id": "hostA", "final": True, "time": 0.0,
         "interval_s": 1.0}))
    return root


def _noop(root, tmp):
    return {"expect_complete": True}


def _tmp_litter(root, tmp):
    (root / "v9_resnet.npy.k3j2.tmp").write_bytes(b"half a write")


def _corrupt_artifact(root, tmp):
    path = root / "v0_resnet.npy"
    data = bytearray(path.read_bytes())
    data[-3] ^= 0xFF
    path.write_bytes(bytes(data))


def _span_sha_mismatch(root, tmp):
    arr = np.zeros((4, 4), np.float32)
    np.save(root / "v0_resnet.npy", arr)
    append_jsonl(root / "_health.jsonl",
                 digest_array("resnet", arr, video="v0.mp4",
                              feature_type="resnet"))


def _artifact_missing(root, tmp):
    (root / "v0_resnet.npy").unlink()


def _tail_torn(root, tmp):
    with open(root / "_health.jsonl", "ab") as f:
        f.write(b'{"schema": "vft.feature_health/1", "video": "torn')
    return {"expect_complete": True}


def _midfile_torn(root, tmp):
    _tail_torn(root, tmp)
    with open(root / "_health.jsonl", "ab") as f:
        f.write(b'\n{"video": "v9.mp4"}\n')


def _done_without_artifact(root, tmp):
    (root / "_queue" / "done" / "v7-dddd.json").write_text(json.dumps(
        {"id": "v7-dddd", "video": "v7.mp4", "status": "done",
         "by": "hostA"}))


def _error_without_journal(root, tmp):
    (root / "_queue" / "done" / "v8-eeee.json").write_text(json.dumps(
        {"id": "v8-eeee", "video": "v8.mp4", "status": "error",
         "by": "hostA"}))


def _quarantined_without_poison(root, tmp):
    (root / "_queue" / "quarantined" / "v5-ffff.json").write_text(
        json.dumps({"id": "v5-ffff", "video": "v5.mp4", "reclaims": 4}))


def _orphaned_claim(root, tmp):
    (root / "_queue" / "claimed" / "hostA" / "v3-gggg.json").write_text(
        json.dumps({"id": "v3-gggg", "video": "v3.mp4",
                    "host_id": "hostA", "deadline": 1.0}))


def _stale_claim(root, tmp):
    hostb = root / "_queue" / "claimed" / "hostB"
    hostb.mkdir()
    (hostb / "v4-hhhh.json").write_text(json.dumps(
        {"id": "v4-hhhh", "video": "v4.mp4", "host_id": "hostB",
         "deadline": 1.0}))


def _stale_claim_complete(root, tmp):
    _stale_claim(root, tmp)
    return {"expect_complete": True}


def _stranded_staging(root, tmp):
    (root / "_queue" / ".staging" / "ab12cd34.v6-iiii.json").write_text(
        json.dumps({"id": "v6-iiii", "video": "v6.mp4"}))
    return {"expect_complete": True}


def _staging_leftover_done(root, tmp):
    (root / "_queue" / ".staging" / "ab12cd34.v0-aaaa.json").write_text(
        json.dumps({"id": "v0-aaaa", "video": "v0.mp4"}))
    return {"expect_complete": True}


def _pending_leftover(root, tmp):
    (root / "_queue" / "pending" / "v6-jjjj.json").write_text(
        json.dumps({"id": "v6-jjjj", "video": "v6.mp4"}))


def _pending_leftover_complete(root, tmp):
    _pending_leftover(root, tmp)
    return {"expect_complete": True}


def _nonfinite_with_artifact(root, tmp):
    arr = np.full((2, 2), np.nan, np.float32)
    np.save(root / "v0_bad.npy", arr)
    append_jsonl(root / "_health.jsonl",
                 digest_array("bad", arr, video="v0.mp4",
                              feature_type="resnet"))


def _cache_store(tmp) -> Path:
    from video_features_tpu_torch.cache import FeatureCache
    video = tmp / "content.bin"
    video.write_bytes(b"cache me")
    store = tmp / "cachestore"
    FeatureCache(str(store / "resnet"), "resnet", "cfg", "wts").store(
        str(video), {"resnet": np.ones((3, 3), np.float32)})
    return store


def _cache_good(root, tmp):
    return {"cache_dir": str(_cache_store(tmp)), "expect_complete": True}


def _cache_corrupt(root, tmp):
    store = _cache_store(tmp)
    entry = next(store.rglob("*.pkl"))
    data = bytearray(entry.read_bytes())
    data[len(data) // 2] ^= 0xFF
    entry.write_bytes(bytes(data))
    return {"cache_dir": str(store)}


def _cache_from_manifest(root, tmp):
    """No ``--cache-dir``: the store a ``_run.json`` names is found."""
    store = _cache_store(tmp)
    (root / "_run.json").write_text(json.dumps({"run_config": {
        "cache": True, "cache_dir": str(store)}}))
    next(store.rglob("*.pkl")).write_bytes(b"not a pickle")


def _spool(root) -> Path:
    spool = root / "spool"
    for d in ("requests", "claimed", "done", "expired", "inbox"):
        (spool / d).mkdir(parents=True, exist_ok=True)
    return spool


def _expired_and_done(root, tmp):
    spool = _spool(root)
    (spool / "done" / "r1.json").write_text(json.dumps({"status": "done"}))
    (spool / "expired" / "r1.json").write_text(json.dumps(
        {"status": "deadline_exceeded", "processed": 1}))


def _expired_at_claim_with_span(root, tmp):
    spool = _spool(root)
    (spool / "expired" / "r2.json").write_text(json.dumps(
        {"status": "deadline_exceeded", "processed": 0}))
    append_jsonl(root / "_telemetry.jsonl", {"request_id": "r2",
                                             "video": "v0.mp4"})


def _gateway_journal(spool: Path, *recs) -> None:
    for rec in recs:
        append_jsonl(spool / "_gateway_gw1.jsonl", rec)


def _orphaned_upload(root, tmp):
    spool = _spool(root)
    (spool / "inbox" / "blob1").write_bytes(b"x")
    (spool / "inbox" / "blob2").write_bytes(b"y")
    _gateway_journal(spool, {"event": "upload", "tenant": "a",
                             "path": str(spool / "inbox" / "blob1")})


def _refused_reached_spool(root, tmp):
    spool = _spool(root)
    (spool / "requests" / "r3.json").write_text("{}")
    _gateway_journal(spool, {"event": "shed", "id": "r3", "tenant": "a"})


def _tenant_unreconciled(root, tmp):
    spool = _spool(root)
    (spool / "done" / "r4.json").write_text(json.dumps({"status": "done"}))
    _gateway_journal(spool,
                     {"event": "accepted", "id": "r4", "tenant": "a"},
                     {"event": "accepted", "id": "r5", "tenant": "a"})
    return {"expect_complete": True}


def _tenant_open(root, tmp):
    _tenant_unreconciled(root, tmp)
    return {}


def _gc_remnant(root, tmp):
    victim = root / "done" / "r1.json"
    victim.parent.mkdir()
    victim.write_text("{}")
    d = tgc.Deletion("spool", str(victim), 2, "test remnant")
    append_jsonl(root / tgc.journal_filename("h1"),
                 tgc._journal_record(d, str(root), "h1"))
    return {"expect_complete": True}


def _gc_deleted_referenced(root, tmp):
    (root / "requests").mkdir()
    (root / "requests" / "r1.json").write_text(json.dumps(
        {"id": "r1", "video_paths": [str(root / "inbox" / "blobZ")]}))
    jp = root / tgc.journal_filename("h1")
    for plane, path in (("spool", root / "done" / "r1.json"),
                        ("inbox", root / "inbox" / "blobZ")):
        append_jsonl(jp, tgc._journal_record(
            tgc.Deletion(plane, str(path), 1, "bad"), str(root), "h1"))


def _scenario(root, tmp, **over):
    doc = {"schema": SCENARIO_SCHEMA, "offered": 3, "admitted": 2,
           "completed": 2, "expired": 0, "rejected": 1, "shed": 0,
           "errors": 0, "journal": "_loadgen.jsonl", "verdict": "PASS",
           "audit": {"pass": True},
           "tenants": {"a": {"offered": 3, "admitted": 2, "completed": 2,
                             "rejected": 1}}}
    doc.update(over)
    (root / "drill").mkdir()
    (root / "drill" / "_scenario.json").write_text(json.dumps(doc))
    for _ in range(3):
        append_jsonl(root / "drill" / "_loadgen.jsonl",
                     {"event": "request"})


def _scenario_good(root, tmp):
    _scenario(root, tmp)
    return {"expect_complete": True}


def _scenario_bad_headline(root, tmp):
    _scenario(root, tmp, offered=4, verdict="PASS",
              audit={"pass": False})


def _scenario_bad_schema(root, tmp):
    _scenario(root, tmp, schema="vft.scenario/0")


#: case -> (mutation, the verdict, a phrase of a violation or note)
CASES = {
    "consistent": (_noop, True, None),
    "tmp_litter": (_tmp_litter, False, "tmp litter"),
    "corrupt_artifact": (_corrupt_artifact, False, "signature mismatch"),
    "span_sha_mismatch": (_span_sha_mismatch, False, "sha256"),
    "artifact_missing": (_artifact_missing, False, "absent on disk"),
    "tail_torn": (_tail_torn, True, "torn trailing record"),
    "midfile_torn": (_midfile_torn, False, "corrupt record at line"),
    "done_without_artifact": (_done_without_artifact, False,
                              "has no artifact"),
    "error_without_journal": (_error_without_journal, False,
                              "no failure journal"),
    "quarantined_without_poison": (_quarantined_without_poison, False,
                                   "no POISON record"),
    "orphaned_claim": (_orphaned_claim, False, "orphaned claim"),
    "stale_claim": (_stale_claim, True, "in-flight claim"),
    "stale_claim_complete": (_stale_claim_complete, False,
                             "leftover claim"),
    "stranded_staging": (_stranded_staging, False, "stranded in staging"),
    "staging_leftover_done": (_staging_leftover_done, True,
                              "staging leftover"),
    "pending_leftover": (_pending_leftover, True, None),
    "pending_leftover_complete": (_pending_leftover_complete, False,
                                  "pending item"),
    "nonfinite_with_artifact": (_nonfinite_with_artifact, False,
                                "non-finite"),
    "cache_good": (_cache_good, True, None),
    "cache_corrupt": (_cache_corrupt, False, "cache entry"),
    "cache_from_manifest": (_cache_from_manifest, False, "cache entry"),
    "expired_and_done": (_expired_and_done, False, "BOTH a done/"),
    "expired_at_claim_with_span": (_expired_at_claim_with_span, False,
                                   "expired at claim"),
    "orphaned_upload": (_orphaned_upload, False, "orphaned upload"),
    "refused_reached_spool": (_refused_reached_spool, False,
                              "refused (429/503)"),
    "tenant_unreconciled": (_tenant_unreconciled, False, "reconcile"),
    "tenant_open": (_tenant_open, True, "still open"),
    "gc_remnant": (_gc_remnant, True, "gc-journaled"),
    "gc_deleted_referenced": (_gc_deleted_referenced, False, "claimable"),
    "scenario_good": (_scenario_good, True, None),
    "scenario_bad_headline": (_scenario_bad_headline, False,
                              "verdict PASS over a recorded audit"),
    "scenario_bad_schema": (_scenario_bad_schema, False, "schema"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_audit_equals_jax(case, tmp_path):
    mutate, ok_want, phrase = CASES[case]
    root = _mk_consistent_run(tmp_path / "out")
    kw = mutate(root, tmp_path) or {}
    port = taudit_run(str(root), **kw)
    assert port == jaudit_run(str(root), **kw)
    ok, violations, notes = port
    assert ok is ok_want, violations
    if phrase is not None:
        assert any(phrase in m for m in (violations if not ok_want
                                         else notes)), (violations, notes)


def test_gc_deleted_referenced_names_both_rules(tmp_path):
    root = _mk_consistent_run(tmp_path / "out")
    _gc_deleted_referenced(root, tmp_path)
    ok, violations, _ = taudit_run(str(root))
    assert not ok
    assert any("claimable" in v for v in violations)
    assert any("still referenced" in v for v in violations)


def test_cli_verdict_and_exit_codes(tmp_path, capsys):
    from video_features_tpu_torch.audit import main as audit_main
    from video_features_tpu_torch.cli import main
    root = _mk_consistent_run(tmp_path / "out")
    with pytest.raises(SystemExit) as e:
        main(["audit", str(root), "--expect-complete"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "AUDIT: PASS" in out and "checked:" in out
    (root / "junk.tmp").write_bytes(b"x")
    assert audit_main([str(root)]) == 1
    out = capsys.readouterr().out
    assert "AUDIT: FAIL" in out and "tmp litter" in out
    assert audit_main([str(tmp_path / "missing")]) == 1
