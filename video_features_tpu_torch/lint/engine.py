"""The `vft-lint` rule engine over the port (port of
``video_features_tpu/lint/engine.py``): parse once, prove every contract.

It scans ``video_features_tpu_torch/`` (the port has no ``scripts/`` of its
own) and reads the port's family YAMLs, its schema JSONs and the shared
``docs/chaos.md``. The design of the JAX package's engine, kept:

  1. **seconds on the whole tree**: it never imports the package under
     analysis (no torch, no numpy); every contract constant
     (``NON_SEMANTIC_KEYS``, ``SITES``, ``*_FIELDS``, the metric registry)
     comes out of the AST with ``ast.literal_eval``, the family YAMLs
     through ``yaml.safe_load``, the schema contracts through ``json.load``;
  2. **stable finding identity**: a finding's fingerprint is
     ``sha1(rule|path|message)``, without the line, so a baseline survives
     unrelated edits above the finding;
  3. **suppressions are part of the contract**: ``# vft-lint:
     disable=VFT0xx — reason`` silences a rule on one line (a comment alone
     on its line, the next line), and a disable without a reason is itself
     reported (VFT000, warn tier);
  4. **grandfathering, not amnesty**: ``--baseline`` with ``--fail-on-new``
     fails only on findings the baseline does not hold. The port's baseline
     is ``video_features_tpu_torch/lint/baseline.json``, and it is empty.

Rules live in :mod:`video_features_tpu_torch.lint.rules` and register
through :func:`rule` with the JAX package's stable ``VFT0xx`` ids; the
engine knows nothing about any one contract. Every path a rule reads is
under :attr:`LintContext.PACKAGE`.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

#: bump when the --json output shape changes (pinned by tests/test_lint.py)
JSON_SCHEMA = "vft.lint/1"

#: the port's baseline file, repo-root-relative (empty: the port lints clean)
BASELINE_FILENAME = "video_features_tpu_torch/lint/baseline.json"

#: tiers: errors fail the run, warnings never do
ERROR, WARN = "error", "warn"

_SUPPRESS_RE = re.compile(
    r"#\s*vft-lint:\s*disable=([A-Za-z0-9,_ ]+?)(?:\s*(?:[—\-:]+)\s*(.*))?$")


class Finding:
    """One rule violation, anchored to a file and line."""

    __slots__ = ("rule", "tier", "path", "line", "message")

    def __init__(self, rule: str, path: str, line: int, message: str,
                 tier: str = ERROR) -> None:
        self.rule = rule
        self.tier = tier
        self.path = path
        self.line = int(line)
        self.message = message

    @property
    def fingerprint(self) -> str:
        # line numbers excluded on purpose: a baseline must survive
        # unrelated edits that shift the finding down the file
        blob = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "tier": self.tier, "path": self.path,
                "line": self.line, "message": self.message,
                "fingerprint": self.fingerprint}

    def render(self) -> str:
        mark = "warning" if self.tier == WARN else "error"
        return f"{self.path}:{self.line}: {self.rule} [{mark}] {self.message}"


#: rule id -> (function, tier, title)
_RULES: Dict[str, Tuple[Callable[["LintContext"], List[Finding]], str, str]] \
    = {}


def rule(rule_id: str, title: str, tier: str = ERROR):
    """Register a rule. The function receives a :class:`LintContext` and
    returns findings; its id is stable forever (suppressions and
    baselines reference it)."""
    def deco(fn):
        if rule_id in _RULES:
            raise ValueError(f"duplicate lint rule id {rule_id}")
        _RULES[rule_id] = (fn, tier, title)
        fn.rule_id = rule_id
        fn.title = title
        return fn
    return deco


def registered_rules() -> Dict[str, Tuple[Callable, str, str]]:
    _load_rules()
    return dict(_RULES)


class ParsedModule:
    """One parsed source file: AST + raw lines + per-line suppressions."""

    def __init__(self, relpath: str, source: str) -> None:
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        #: line -> (set of rule ids or {'all'}, has_reason)
        self.suppressions: Dict[int, Tuple[set, bool]] = {}
        self._docstring_ids = self._collect_docstrings()
        self._scan_suppressions()

    def _collect_docstrings(self) -> set:
        ids = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                body = getattr(node, "body", [])
                if body and isinstance(body[0], ast.Expr) and \
                        isinstance(body[0].value, ast.Constant) and \
                        isinstance(body[0].value.value, str):
                    ids.add(id(body[0].value))
        return ids

    def is_docstring(self, node: ast.AST) -> bool:
        return id(node) in self._docstring_ids

    def _scan_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            reason = (m.group(2) or "").strip()
            # a comment alone on its line suppresses the NEXT line (the
            # flagged statement is often too long to share a line with
            # its justification)
            target = i + 1 if line.lstrip().startswith("#") else i
            self.suppressions[target] = (rules, bool(reason))

    def suppressed(self, line: int, rule_id: str) -> bool:
        entry = self.suppressions.get(line)
        if not entry:
            return False
        rules, _ = entry
        return "ALL" in rules or rule_id.upper() in rules


class LintContext:
    """Everything the rules read: parsed sources, family YAMLs, schema
    JSONs and the chaos doc — loaded once, shared by every rule."""

    #: the package under analysis
    PACKAGE = "video_features_tpu_torch"

    def __init__(self, repo_root: str) -> None:
        self.repo_root = Path(repo_root).resolve()
        self.pkg_root = self.repo_root / self.PACKAGE
        if not self.pkg_root.is_dir():
            raise FileNotFoundError(
                f"{self.pkg_root} not found — vft-lint must run from (or "
                f"be pointed at) the repository root")
        self.modules: Dict[str, ParsedModule] = {}
        self.parse_errors: List[Finding] = []
        self._const_cache: Dict[str, Dict[str, Any]] = {}
        self._load_sources()
        self.configs = self._load_configs()

    # -- loading -----------------------------------------------------------
    def _iter_source_files(self) -> Iterable[Path]:
        yield from sorted(self.pkg_root.rglob("*.py"))

    def _load_sources(self) -> None:
        for path in self._iter_source_files():
            if "__pycache__" in path.parts:
                continue
            rel = str(path.relative_to(self.repo_root))
            try:
                self.modules[rel] = ParsedModule(rel, path.read_text())
            except (OSError, SyntaxError) as e:
                # a file the engine cannot parse is maximal drift for
                # every rule that would have read it: surface it instead
                # of silently analyzing a partial tree
                self.parse_errors.append(Finding(
                    "VFT000", rel, getattr(e, "lineno", 1) or 1,
                    f"unparseable source: {type(e).__name__}: {e}"))

    def _load_configs(self) -> Dict[str, Dict[str, Any]]:
        import yaml
        out: Dict[str, Dict[str, Any]] = {}
        cfg_dir = self.pkg_root / "configs"
        for p in sorted(cfg_dir.glob("*.yml")):
            try:
                out[p.stem] = dict(yaml.safe_load(p.read_text()) or {})
            except Exception as e:
                self.parse_errors.append(Finding(
                    "VFT000", str(p.relative_to(self.repo_root)), 1,
                    f"unparseable family YAML: {type(e).__name__}: {e}"))
        return out

    # -- shared readers ----------------------------------------------------
    def package_modules(self) -> Dict[str, ParsedModule]:
        prefix = self.PACKAGE + os.sep
        return {rel: m for rel, m in self.modules.items()
                if rel.startswith(prefix)}

    def module(self, relpath: str) -> Optional[ParsedModule]:
        return self.modules.get(relpath)

    _CONTAINER_CALLS = {"frozenset", "set", "tuple", "list", "dict"}

    def constants(self, relpath: str) -> Dict[str, Any]:
        """Module-level contract constants: plain literal assignments
        (``NAME = <literal>``) plus ``frozenset({...})``-style wrappers
        around one literal argument, ``ast.literal_eval``-ed. Anything
        non-literal is skipped — the contract constants the rules read
        are all plain literals by design."""
        if relpath in self._const_cache:
            return self._const_cache[relpath]
        out: Dict[str, Any] = {}
        mod = self.module(relpath)
        if mod is not None:
            for node in mod.tree.body:
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                value = node.value
                if isinstance(value, ast.Call) and \
                        isinstance(value.func, ast.Name) and \
                        value.func.id in self._CONTAINER_CALLS and \
                        len(value.args) == 1 and not value.keywords:
                    value = value.args[0]
                try:
                    out[node.targets[0].id] = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    continue
        self._const_cache[relpath] = out
        return out

    def load_json(self, relpath: str) -> Optional[dict]:
        p = self.repo_root / relpath
        try:
            return json.loads(p.read_text())
        except (OSError, ValueError):
            return None

    def read_text(self, relpath: str) -> Optional[str]:
        try:
            return (self.repo_root / relpath).read_text()
        except OSError:
            return None

    def line_of(self, relpath: str, needle: str, default: int = 1) -> int:
        """First line containing ``needle`` — anchors findings about a
        missing entry to the declaration it should be added to."""
        mod = self.module(relpath)
        if mod is None:
            return default
        for i, line in enumerate(mod.lines, start=1):
            if needle in line:
                return i
        return default


def _load_rules() -> None:
    # import for side effects: rules.py registers itself via @rule
    from . import rules  # noqa: F401


def run_lint(repo_root: str,
             rule_ids: Optional[Iterable[str]] = None
             ) -> Tuple[List[Finding], List[Finding], float]:
    """Run the pass. Returns ``(findings, suppressed, elapsed_s)`` —
    suppressed findings are returned separately so callers can audit
    what the disables are hiding."""
    _load_rules()
    t0 = time.monotonic()
    ctx = LintContext(repo_root)
    findings: List[Finding] = list(ctx.parse_errors)
    wanted = {r.upper() for r in rule_ids} if rule_ids else None
    for rid, (fn, tier, _title) in sorted(_RULES.items()):
        if wanted is not None and rid not in wanted:
            continue
        for f in fn(ctx):
            if tier == WARN:
                f.tier = WARN  # a warn-tier rule can never fail the build
            findings.append(f)
    # meta-rule VFT000: a disable comment without a reason defeats the
    # self-documenting-exceptions contract
    for rel, mod in ctx.modules.items():
        for line, (rules, has_reason) in sorted(mod.suppressions.items()):
            if not has_reason:
                findings.append(Finding(
                    "VFT000", rel, min(line, len(mod.lines) or 1),
                    f"suppression without a reason: disable="
                    f"{','.join(sorted(rules))} — append '— <why>' so the "
                    f"exception documents itself", tier=WARN))
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        mod = ctx.modules.get(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            suppressed.append(f)
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept, suppressed, time.monotonic() - t0


# -- baseline ----------------------------------------------------------------

def load_baseline(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "fingerprints" not in doc:
        raise ValueError(f"{path}: not a vft-lint baseline "
                         "(expected {{'fingerprints': [...]}})")
    return set(doc["fingerprints"])


def write_baseline(path: str, findings: List[Finding]) -> int:
    errors = [f for f in findings if f.tier == ERROR]
    doc = {"schema": JSON_SCHEMA, "kind": "baseline",
           "fingerprints": sorted({f.fingerprint for f in errors}),
           "entries": [f.to_dict() for f in errors]}
    from ..utils.sinks import _write_bytes_atomic
    _write_bytes_atomic(path, (json.dumps(doc, indent=2, sort_keys=True)
                               + "\n").encode())
    return len(doc["fingerprints"])


# -- CLI ---------------------------------------------------------------------

def _find_repo_root(start: Optional[str]) -> str:
    if start:
        return start
    for cand in (Path.cwd(), *Path.cwd().parents):
        if (cand / LintContext.PACKAGE / "configs").is_dir():
            return str(cand)
    # the checkout this file lives in
    here = Path(__file__).resolve()
    return str(here.parents[2])


def main(argv: Optional[List[str]] = None) -> int:
    _load_rules()
    ap = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch lint",
        description="Contract-aware static analysis: prove the repo's "
                    "cross-file invariants (cache keying, chaos sites, "
                    "schema lockstep, atomic writes, metric names) "
                    "without running anything.")
    ap.add_argument("root", nargs="?", default=None,
                    help="repository root (default: auto-detect upward "
                         "from the current directory)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (schema "
                         f"{JSON_SCHEMA!r}, pinned by tests)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON of grandfathered fingerprints")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="with --baseline: exit 1 only on findings NOT in "
                         "the baseline")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="write the current error findings as a baseline "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, (_fn, tier, title) in sorted(_RULES.items()):
            print(f"{rid}  [{tier:5s}]  {title}")
        return 0

    root = _find_repo_root(args.root)
    rule_ids = [r for r in (args.rules or "").split(",") if r] or None
    try:
        findings, suppressed, elapsed = run_lint(root, rule_ids)
    except FileNotFoundError as e:
        print(f"vft-lint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        n = write_baseline(args.write_baseline, findings)
        print(f"vft-lint: wrote {n} grandfathered finding(s) to "
              f"{args.write_baseline}")
        return 0

    baseline: set = set()
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"vft-lint: cannot load baseline: {e}", file=sys.stderr)
            return 2

    errors = [f for f in findings if f.tier == ERROR]
    warns = [f for f in findings if f.tier != ERROR]
    new_errors = [f for f in errors if f.fingerprint not in baseline]
    gating = new_errors if (args.baseline and args.fail_on_new) else errors

    if args.json:
        doc = {"schema": JSON_SCHEMA, "root": str(root),
               "elapsed_s": round(elapsed, 3),
               "counts": {"errors": len(errors), "warnings": len(warns),
                          "suppressed": len(suppressed),
                          "new_errors": len(new_errors),
                          "baselined": len(errors) - len(new_errors)},
               "findings": [dict(f.to_dict(),
                                 new=f.fingerprint not in baseline)
                            for f in findings]}
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 1 if gating else 0

    for f in findings:
        tag = ""
        if args.baseline and f.tier == ERROR and f.fingerprint in baseline:
            tag = " (baselined)"
        print(f.render() + tag)
    verdict = "FAIL" if gating else "PASS"
    extra = f", {len(errors) - len(new_errors)} baselined" if baseline else ""
    print(f"vft-lint: {verdict} — {len(errors)} error(s) "
          f"({len(new_errors)} new{extra}), {len(warns)} warning(s), "
          f"{len(suppressed)} suppressed, {len(_RULES)} rules "
          f"in {elapsed:.2f}s")
    return 1 if gating else 0


if __name__ == "__main__":
    raise SystemExit(main())
