"""vft-lint over the port (``video_features_tpu_torch/lint/``) against the
JAX package's (``tests/test_lint.py``).

- every per-rule case of JAX ``tests/test_lint.py``: on the synthetic
  mini-repo (JAX's ``make_repo``, its package renamed to the port's) the
  port's engine fires on the seeded violation, and stays quiet once it is
  fixed the way the finding says;
- on that mini-repo in the JAX package's layout, with each case's
  violation seeded, the port's engine (pointed at the JAX package's name)
  and JAX's give the same findings with the same fingerprints;
- the engine's contracts: suppressions, the unreasoned-suppression
  warning, the baseline, the ``vft.lint/1`` JSON, fingerprints that
  survive a line shift;
- the port's own tree lints clean under its empty baseline, every
  suppression carries a reason, and the ``lint`` subcommand's exit codes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_lint import make_repo
from video_features_tpu.lint import engine as jengine
from video_features_tpu_torch.config import (LAUNCH_KEYS, OPTIONAL_KEYS,
                                             REMOVED_KEYS)
from video_features_tpu_torch.lint import engine
from video_features_tpu_torch.lint.engine import run_lint

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = "video_features_tpu_torch"
JAX = "video_features_tpu"


def port_repo(tmp_path: Path) -> Path:
    """JAX's clean mini-repo with its package under the port's name."""
    root = make_repo(tmp_path)
    (root / JAX).rename(root / PORT)
    return root


def _edit(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert old in text, (path, old)
    path.write_text(text.replace(old, new))


def errors_of(findings, rule=None):
    return [f for f in findings if f.tier == engine.ERROR
            and (rule is None or f.rule == rule)]


def warns_of(findings, rule=None):
    return [f for f in findings if f.tier == engine.WARN
            and (rule is None or f.rule == rule)]


# -- the cases: (rule, seed(root, pkg), fired(findings) -> bool, fix) --------

def _append_yaml_key(root, pkg):
    yml = root / pkg / "configs/a.yml"
    yml.write_text(yml.read_text() + "newknob: 3\n")


def _classify_newknob(root, pkg):
    _edit(root / pkg / "cache.py", '"spool_dir",', '"spool_dir", "newknob",')


def _double_classify(root, pkg):
    _edit(root / pkg / "cache.py", '"feature_type",', '"feature_type", "cache",')


def _stale_classify(root, pkg):
    _edit(root / pkg / "cache.py", '"alpha",', '"alpha", "ghost_knob",')


def _validated_ghost(root, pkg):
    _edit(root / pkg / "config.py", 'args.get("cache")',
          'args.get("cache")\n    args.get("ghost")')


def _undeclare_alpha(root, pkg):
    _edit(root / pkg / "config.py", 'OPTIONAL_KEYS = frozenset({"alpha"})',
          'OPTIONAL_KEYS = frozenset({"unused_decl"})')


def _undeclared_read(root, pkg):
    mod = root / pkg / "serve.py"
    mod.write_text(mod.read_text() + "\n\ndef poll(args):\n"
                   "    return args.get('spool_poll_s')\n")


def _declare_in_yamls(root, pkg):
    for fam in ("a", "b"):
        yml = root / pkg / f"configs/{fam}.yml"
        yml.write_text(yml.read_text() + "spool_poll_s: 0.25\n")


def _argparse_namespace(root, pkg):
    (root / pkg / "gateway.py").write_text(
        "import argparse\n\n\ndef main(argv):\n"
        "    ap = argparse.ArgumentParser()\n"
        "    args = ap.parse_args(argv)\n"
        "    return args.get('prom'), args.verbose\n")


def _typo_site(root, pkg):
    _edit(root / pkg / "utils/sinks.py", 'inject.fire("sink.write"',
          'inject.fire("sink.typo"')


def _no_doc_table(root, pkg):
    (root / "docs/chaos.md").write_text("# chaos\n\nno table here\n")


_RAW = ("import json\n\n\ndef flush(path, doc):\n"
        "    with open(path, 'w') as f:\n        json.dump(doc, f)\n")


def _raw_write(root, pkg):
    (root / pkg / "telemetry/heartbeat.py").write_text(_RAW)


def _suppress_raw_write(root, pkg):
    (root / pkg / "telemetry/heartbeat.py").write_text(_RAW.replace(
        "    with open", "    # vft-lint: disable=VFT004 — test fixture "
        "reason\n    with open"))


def _np_save(root, pkg):
    (root / pkg / "telemetry/heartbeat.py").write_text(
        "import io\nimport numpy as np\n\n\n"
        "def a(path, v):\n    np.save(path, v)\n\n\n"
        "def b(v):\n    buf = io.BytesIO()\n"
        "    np.save(buf, v)\n    return buf.getvalue()\n")


def _read_mode(root, pkg):
    (root / pkg / "telemetry/heartbeat.py").write_text(
        "def load(path):\n    with open(path) as f:\n        return f.read()\n")


def _mystery_metric(root, pkg):
    _edit(root / pkg / "utils/sinks.py", 'telemetry.inc("vft_writes_total")',
          'telemetry.inc("vft_writes_total")\n'
          '    telemetry.inc("vft_mystery_total")')


def _register_mystery(root, pkg):
    _edit(root / pkg / "telemetry/names.py", '"vft_writes_total": "counter",',
          '"vft_writes_total": "counter",\n    "vft_mystery_total": "counter",')


def _bad_counter(root, pkg):
    (root / pkg / "telemetry/names.py").write_text(
        'METRICS = {\n    "vft_writes_total": "gauge",\n'
        '    "vft_bad_counter": "counter",\n}\n')


def _orphan_metric(root, pkg):
    _edit(root / pkg / "telemetry/names.py", '"vft_writes_total": "counter",',
          '"vft_writes_total": "counter",\n    "vft_orphan_total": "counter",')


def _drop_schema_property(root, pkg):
    sj = root / pkg / "telemetry/video_span.schema.json"
    doc = json.loads(sj.read_text())
    del doc["properties"]["video"]
    doc["required"] = ["schema"]
    sj.write_text(json.dumps(doc))


def _enum_drift(root, pkg):
    _edit(root / pkg / "telemetry/alerts.py",
          '("pending", "firing", "resolved")',
          '("pending", "firing", "resolved", "silenced")')


def _roofline_drift(root, pkg):
    _edit(root / pkg / "telemetry/roofline.py", 'CARD_FIELDS = ("flops",)',
          'CARD_FIELDS = ("flops", "bytes")')


def _unlocked(root, pkg):
    _edit(root / pkg / "serve.py",
          '    with _LOCK:\n        _OPEN[rid] = "queued"',
          '    _OPEN[rid] = "queued"')


def _unreasoned(root, pkg):
    (root / pkg / "telemetry/heartbeat.py").write_text(
        "def flush(path, doc):\n    # vft-lint: disable=VFT004\n"
        "    with open(path, 'w') as f:\n        f.write(doc)\n")


def _has(rule, text, tier=engine.ERROR):
    return lambda fs: any(f.rule == rule and f.tier == tier
                          and text in f.message for f in fs)


CASES = {
    "vft001_unclassified": ("VFT001", _append_yaml_key,
                            _has("VFT001", "'newknob' is unclassified"),
                            _classify_newknob),
    "vft001_double": ("VFT001", _double_classify, _has("VFT001", "BOTH"),
                      None),
    "vft001_stale": ("VFT001", _stale_classify,
                     _has("VFT001", "stale", engine.WARN), None),
    "vft002_validated_no_yaml": ("VFT002", _validated_ghost,
                                 _has("VFT002",
                                      "validated config key 'ghost'"), None),
    "vft002_partial_yaml": ("VFT002", _undeclare_alpha,
                            lambda fs: _has(
                                "VFT002", "'alpha' appears in only some "
                                "family YAMLs")(fs) and _has(
                                "VFT002", "'unused_decl'",
                                engine.WARN)(fs), None),
    "vft002_undeclared_read": ("VFT002", _undeclared_read,
                               _has("VFT002", "'spool_poll_s' is read here "
                                    "but declared nowhere"),
                               _declare_in_yamls),
    "vft002_argparse": ("VFT002", _argparse_namespace, None, None),
    "vft003_unregistered": ("VFT003", _typo_site,
                            lambda fs: _has(
                                "VFT003", "'sink.typo' is fired here but "
                                "not registered")(fs) and _has(
                                "VFT003", "'sink.write' has no fire()/"
                                "check() call site")(fs), None),
    "vft003_doc_row": ("VFT003", _no_doc_table,
                       _has("VFT003", "no row in the docs/chaos.md site "
                            "table"), None),
    "vft004_raw_write": ("VFT004", _raw_write,
                         lambda fs: len(errors_of(fs, "VFT004")) == 1,
                         _suppress_raw_write),
    "vft004_np_save": ("VFT004", _np_save,
                       lambda fs: [f.line for f in errors_of(fs, "VFT004")]
                       == [6], None),
    "vft004_read_mode": ("VFT004", _read_mode, None, None),
    "vft005_undeclared": ("VFT005", _mystery_metric,
                          _has("VFT005", "'vft_mystery_total' is not "
                               "declared"), _register_mystery),
    "vft005_naming_kind": ("VFT005", _bad_counter,
                           lambda fs: _has(
                               "VFT005", "'vft_bad_counter' must end in "
                               "_total")(fs) and _has(
                               "VFT005", "declared a gauge but used via "
                               ".inc()")(fs), None),
    "vft005_unused": ("VFT005", _orphan_metric,
                      _has("VFT005", "'vft_orphan_total' is referenced "
                           "nowhere", engine.WARN), None),
    "vft006_missing_property": ("VFT006", _drop_schema_property,
                                _has("VFT006", "emitter field 'video' "
                                     "missing from the schema"), None),
    "vft006_enum_drift": ("VFT006", _enum_drift,
                          _has("VFT006", "'state' enum"), None),
    "vft006_roofline_nested": ("VFT006", _roofline_drift,
                               lambda fs: any(
                                   "roofline.card" in f.message
                                   and "'bytes'" in f.message
                                   for f in errors_of(fs, "VFT006")), None),
    "vft007_unlocked": ("VFT007", _unlocked,
                        lambda fs: [("_OPEN" in f.message) for f in
                                    warns_of(fs, "VFT007")] == [True], None),
    "vft000_unreasoned": (None, _unreasoned,
                          _has("VFT000", "without a reason", engine.WARN),
                          None),
}


def test_clean_mini_repo_passes(tmp_path):
    findings, suppressed, _ = run_lint(str(port_repo(tmp_path)))
    assert findings == [] and suppressed == []


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_rule_fires_then_fix_is_quiet(tmp_path, case):
    rule_id, seed, fired, fix = CASES[case]
    root = port_repo(tmp_path)
    seed(root, PORT)
    rules = [rule_id] if rule_id else None
    findings, suppressed, _ = run_lint(str(root), rules)
    if fired is None:  # a case that must not fire
        assert errors_of(findings, rule_id) == []
        return
    assert fired(findings), [f.render() for f in findings]
    if rule_id:
        assert all(f.path.startswith(PORT + "/") or f.path.startswith("docs")
                   for f in findings if f.rule == rule_id)
    if fix is not None:
        fix(root, PORT)
        findings, suppressed, _ = run_lint(str(root), rules)
        assert errors_of(findings, rule_id) == []
        if case == "vft004_raw_write":
            assert len(suppressed) == 1


@pytest.mark.parametrize("case", ["clean"] + list(CASES),
                         ids=["clean"] + list(CASES))
def test_findings_and_fingerprints_equal_jax(tmp_path, monkeypatch, case):
    root = make_repo(tmp_path)
    if case != "clean":
        CASES[case][1](root, JAX)
    monkeypatch.setattr(engine.LintContext, "PACKAGE", JAX)

    def rows(findings):
        return [(f.rule, f.tier, f.path, f.line, f.message, f.fingerprint)
                for f in findings]

    port = run_lint(str(root))
    jax = jengine.run_lint(str(root))
    assert rows(port[0]) == rows(jax[0])
    assert rows(port[1]) == rows(jax[1])


def test_rule_table_equals_jax():
    assert {k: (v[1], v[2]) for k, v in engine.registered_rules().items()} \
        == {k: (v[1], v[2]) for k, v in jengine.registered_rules().items()}
    assert engine.JSON_SCHEMA == jengine.JSON_SCHEMA


# -- engine contracts ----------------------------------------------------------

def test_baseline_grandfathers_then_fails_on_new(tmp_path, capsys):
    root = port_repo(tmp_path)
    mod = root / PORT / "telemetry/heartbeat.py"
    mod.write_text("def flush(path, doc):\n"
                   "    with open(path, 'w') as f:\n        f.write(doc)\n")
    base = tmp_path / "baseline.json"
    assert engine.main([str(root), "--write-baseline", str(base)]) == 0
    assert engine.main([str(root), "--baseline", str(base),
                        "--fail-on-new"]) == 0
    assert engine.main([str(root)]) == 1
    mod.write_text(mod.read_text() + "\n\ndef flush2(path, doc):\n"
                   "    with open(path, 'wb') as f:\n        f.write(doc)\n")
    capsys.readouterr()
    assert engine.main([str(root), "--baseline", str(base),
                        "--fail-on-new"]) == 1
    out = capsys.readouterr().out
    assert "(baselined)" in out and "1 new" in out


def test_json_output_schema_stable(tmp_path, capsys):
    root = port_repo(tmp_path)
    (root / PORT / "telemetry/heartbeat.py").write_text(
        "def flush(path, doc):\n"
        "    with open(path, 'w') as f:\n        f.write(doc)\n")
    rc = engine.main([str(root), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["schema"] == "vft.lint/1"
    assert set(doc["counts"]) == {"errors", "warnings", "suppressed",
                                  "new_errors", "baselined"}
    f = [x for x in doc["findings"] if x["rule"] == "VFT004"][0]
    assert set(f) == {"rule", "tier", "path", "line", "message",
                      "fingerprint", "new"}
    assert f["new"] is True and f["path"].startswith(PORT + "/")


def test_fingerprint_survives_line_shift(tmp_path):
    root = port_repo(tmp_path)
    mod = root / PORT / "telemetry/heartbeat.py"
    body = ("def flush(path, doc):\n"
            "    with open(path, 'w') as f:\n        f.write(doc)\n")
    mod.write_text(body)
    f1 = errors_of(run_lint(str(root), ["VFT004"])[0])[0]
    mod.write_text("# a comment\n# another\n" + body)
    f2 = errors_of(run_lint(str(root), ["VFT004"])[0])[0]
    assert f1.line != f2.line and f1.fingerprint == f2.fingerprint


# -- the port's tree -------------------------------------------------------------

def test_port_tree_lints_clean_under_its_empty_baseline():
    base = REPO_ROOT / engine.BASELINE_FILENAME
    assert engine.load_baseline(str(base)) == set()
    findings, suppressed, elapsed = run_lint(str(REPO_ROOT))
    assert findings == [], [f.render() for f in findings]
    assert {f.rule for f in suppressed} <= {"VFT004", "VFT005"}
    assert all(f.path.startswith(PORT + "/") for f in suppressed)
    assert elapsed < 30.0


def test_port_suppressions_all_reasoned():
    ctx = engine.LintContext(str(REPO_ROOT))
    for rel, mod in ctx.modules.items():
        for line, (_rules, has_reason) in mod.suppressions.items():
            assert has_reason, f"{rel}:{line}"


def test_declared_key_lists_equal_jax():
    """Held equal wherever both packages have the key: every declared key
    the port's YAMLs or validators know is declared alike in JAX."""
    from video_features_tpu import config as jconfig
    assert OPTIONAL_KEYS == jconfig.OPTIONAL_KEYS
    assert LAUNCH_KEYS == jconfig.LAUNCH_KEYS
    assert REMOVED_KEYS == jconfig.REMOVED_KEYS


def test_device_ids_is_removed_as_in_jax(tmp_path, capsys):
    from video_features_tpu_torch import config as tconfig
    cfg = tconfig.load_config("resnet", {
        "video_paths": "v.mp4", "device": "cpu", "device_ids": [0, 1],
        "output_path": str(tmp_path / "o"), "tmp_path": str(tmp_path / "t")})
    tconfig.sanity_check(cfg)
    assert "device_ids" not in cfg
    assert "removed reference flag" in capsys.readouterr().out


@pytest.mark.parametrize("argv,rc", [
    ([], 0), (["--json"], 0), (["--rules", "VFT004"], 0),
    (["--list-rules"], 0), (["{bad}"], 1), (["/no/such/root"], 2),
    (["--baseline", "/no/such.json"], 2)])
def test_lint_subcommand_exit_codes(tmp_path, argv, rc):
    bad = port_repo(tmp_path)
    (bad / PORT / "telemetry/heartbeat.py").write_text(
        "def flush(path, doc):\n"
        "    with open(path, 'w') as f:\n        f.write(doc)\n")
    argv = [str(bad) if a == "{bad}" else a for a in argv]
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    p = subprocess.run([sys.executable, "-m", PORT, "lint"] + argv,
                       cwd=REPO_ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == rc, p.stdout + p.stderr
    if argv == ["--json"]:
        assert json.loads(p.stdout)["root"] == str(REPO_ROOT)
    if argv == ["--list-rules"]:
        assert p.stdout.count("VFT00") == 7
    if rc == 0 and argv[:1] == []:
        assert "vft-lint: PASS" in p.stdout
