"""The port's contracts, as mechanical rules (VFT001-VFT007; port of
``video_features_tpu/lint/rules.py``).

Each rule encodes one cross-file invariant of the JAX package that the
port keeps too. They are pure functions of the parsed tree: no imports of
the analyzed package, no execution. Every path they read is relative to
the package under analysis (:attr:`LintContext.PACKAGE`), so the same
rules run over either package's layout; the chaos doc is the repository's
``docs/chaos.md`` (the two packages' site names are the same).

Shared extraction heuristics (findings depend on them):

  * a **config read** is ``X.get("k")``, ``X["k"]``, ``"k" in X`` or
    ``X.k`` where ``X`` is a name ``args``/``cli_args`` or any
    ``*.args`` attribute, the repo-wide naming convention for the
    sanity-checked config mapping. Dict/Config method names are never
    treated as keys;
  * a **validator** is any function named ``sanity_check*`` or
    ``validate_*``; the config keys it reads are the "validated" set;
  * contract constants (``NON_SEMANTIC_KEYS``, ``SITES``, ``*_FIELDS``,
    ``METRICS``...) are extracted from module-level literal assignments
    (including ``frozenset({...})``-style single-literal-arg calls).
"""
from __future__ import annotations

import ast
import re
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from .engine import WARN, Finding, LintContext, ParsedModule, rule

# -- shared extraction -------------------------------------------------------

#: receivers whose string keys are config keys (the repo-wide convention)
_CFG_NAMES = ("args", "cli_args")

#: attribute names that are mapping API, never config keys
_MAPPING_ATTRS = {
    "get", "items", "keys", "values", "pop", "setdefault", "update",
    "copy", "clear", "to_yaml",
}

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _iter_scope(node: ast.AST) -> Iterable[ast.AST]:
    """Children of ``node`` without descending into nested defs (the
    nested def node itself IS yielded so callers can recurse)."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, _SCOPE_NODES + (ast.Lambda,)):
            yield from _iter_scope(child)


def _is_cfg_receiver(node: ast.AST, excluded: Set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in _CFG_NAMES and node.id not in excluded
    return isinstance(node, ast.Attribute) and node.attr == "args"


def config_key_reads(tree: ast.AST) -> List[Tuple[str, int]]:
    """``(key, line)`` pairs for every config read under ``tree``.

    Scope-aware: a name (re)bound in the enclosing scope from
    ``*.parse_args(...)`` (an argparse namespace) or from a ``.get(...)``
    (a sub-dict of some record) is NOT a config mapping there, however
    it is spelled — CLI tools conventionally call both ``args``."""
    reads: List[Tuple[str, int]] = []

    def _str_arg(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    def _rebound_non_config(scope: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in _iter_scope(scope):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, (ast.Call, ast.BoolOp)):
                value = node.value
                if isinstance(value, ast.BoolOp) and value.values:
                    value = value.values[0]
                fn = getattr(value, "func", None)
                if isinstance(fn, ast.Attribute) and \
                        fn.attr in ("parse_args", "get"):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id in _CFG_NAMES:
                            out.add(t.id)
        return out

    def _visit(scope: ast.AST, inherited: Set[str]) -> None:
        excluded = inherited | _rebound_non_config(scope)
        for node in _iter_scope(scope):
            if isinstance(node, _SCOPE_NODES):
                _visit(node, excluded)
                continue
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                if node.func.attr in ("get", "setdefault", "pop") and \
                        _is_cfg_receiver(node.func.value, excluded) and \
                        node.args:
                    key = _str_arg(node.args[0])
                    if key:
                        reads.append((key, node.lineno))
            elif isinstance(node, ast.Subscript) and \
                    _is_cfg_receiver(node.value, excluded):
                key = _str_arg(node.slice)
                if key:
                    reads.append((key, node.lineno))
            elif isinstance(node, ast.Compare) and \
                    isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
                    _is_cfg_receiver(node.comparators[0], excluded):
                key = _str_arg(node.left)
                if key:
                    reads.append((key, node.lineno))
            elif isinstance(node, ast.Attribute) and \
                    _is_cfg_receiver(node.value, excluded) and \
                    node.attr not in _MAPPING_ATTRS and \
                    not node.attr.startswith("_"):
                reads.append((node.attr, node.lineno))

    _visit(tree, set())
    return reads


def _is_validator(fn: ast.AST) -> bool:
    return isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
        fn.name.startswith("sanity_check") or fn.name.startswith("validate_"))


def validator_keys(ctx: LintContext) -> Dict[str, Tuple[str, int]]:
    """key -> (module, line) for every config key read inside a
    validator function anywhere in the package."""
    out: Dict[str, Tuple[str, int]] = {}
    for rel, mod in ctx.package_modules().items():
        for node in ast.walk(mod.tree):
            if _is_validator(node):
                for key, line in config_key_reads(node):
                    out.setdefault(key, (rel, line))
    return out


def validator_spans(mod: ParsedModule) -> List[Tuple[int, int]]:
    spans = []
    for node in ast.walk(mod.tree):
        if _is_validator(node):
            spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


def _yaml_key_sets(ctx: LintContext) -> Tuple[Set[str], Set[str]]:
    """(union, intersection) of the family YAML key sets."""
    sets = [set(d) for d in ctx.configs.values()]
    if not sets:
        return set(), set()
    return set.union(*sets), set.intersection(*sets)


def _pkg(ctx: LintContext, rel: str) -> str:
    """``rel`` under the package being linted."""
    return f"{ctx.PACKAGE}/{rel}"


_CACHE_PY = "cache.py"
_CONFIG_PY = "config.py"
_INJECT_PY = "utils/inject.py"
_NAMES_PY = "telemetry/names.py"


def _declared(ctx: LintContext, relpath: str, const: str) -> Set[str]:
    val = ctx.constants(relpath).get(const)
    if val is None:
        return set()
    return {str(v) for v in val}


# -- VFT001: cache-fingerprint classification --------------------------------

@rule("VFT001", "every config key is classified semantic or non-semantic "
                "for the cache fingerprint")
def check_cache_classification(ctx: LintContext) -> List[Finding]:
    """The recurring cache-poisoning hazard: ``cache.py`` drops
    ``NON_SEMANTIC_KEYS`` from the config fingerprint and keeps
    everything else. A new operational key that nobody classifies
    silently lands IN the fingerprint — identical features stop sharing
    entries (every new plane's keys had to be classified by hand).
    This rule makes the choice explicit: every key in any family YAML
    and every validator-read key must appear in exactly one of
    ``cache.NON_SEMANTIC_KEYS`` or ``cache.SEMANTIC_KEYS``."""
    findings: List[Finding] = []
    cache_py, config_py = _pkg(ctx, _CACHE_PY), _pkg(ctx, _CONFIG_PY)
    non_semantic = _declared(ctx, cache_py, "NON_SEMANTIC_KEYS")
    semantic = _declared(ctx, cache_py, "SEMANTIC_KEYS")
    if not non_semantic or not semantic:
        missing = [n for n, s in (("NON_SEMANTIC_KEYS", non_semantic),
                                  ("SEMANTIC_KEYS", semantic)) if not s]
        return [Finding("VFT001", cache_py, 1,
                        f"cannot extract {'/'.join(missing)} from cache.py "
                        "— the classification contract is gone")]
    removed = _declared(ctx, config_py, "REMOVED_KEYS")
    launch = _declared(ctx, config_py, "LAUNCH_KEYS")
    yaml_union, _ = _yaml_key_sets(ctx)
    universe = yaml_union | set(validator_keys(ctx))
    anchor = ctx.line_of(cache_py, "NON_SEMANTIC_KEYS = ")

    both = sorted(non_semantic & semantic)
    for key in both:
        findings.append(Finding(
            "VFT001", cache_py, anchor,
            f"config key '{key}' is in BOTH NON_SEMANTIC_KEYS and "
            f"SEMANTIC_KEYS — the fingerprint contract must pick one"))
    for key in sorted(universe - non_semantic - semantic - removed):
        findings.append(Finding(
            "VFT001", cache_py, anchor,
            f"config key '{key}' is unclassified: add it to "
            f"cache.NON_SEMANTIC_KEYS (operational — must NOT perturb the "
            f"cache fingerprint) or cache.SEMANTIC_KEYS (value-bearing — "
            f"must key the cache)"))
    # stale classifications: a key no code, YAML or declaration knows
    code_reads = set()
    for rel, mod in ctx.package_modules().items():
        for key, _line in config_key_reads(mod.tree):
            code_reads.add(key)
    known = universe | launch | removed | code_reads
    for key in sorted((non_semantic | semantic) - known):
        findings.append(Finding(
            "VFT001", cache_py, anchor,
            f"classified key '{key}' no longer exists anywhere (not in "
            f"any family YAML, validator, declared list or code read) — "
            f"delete the stale classification", tier=WARN))
    return findings


# -- VFT002: config keys <-> YAML defaults <-> validation --------------------

@rule("VFT002", "validated keys are declared in the family YAMLs; keys "
                "read in code are declared or validated")
def check_config_key_coverage(ctx: LintContext) -> List[Finding]:
    """Two halves of the config contract:

    (a) every key a validator reads must be carried by ALL family YAMLs,
        or be declared in ``config.OPTIONAL_KEYS`` (family-specific
        defaults), ``config.LAUNCH_KEYS`` (launch-time CLI keys that
        never ride a YAML) or ``config.REMOVED_KEYS`` (legacy, deleted
        at validation);
    (b) every config key read anywhere in the package must be *known*:
        present in at least one family YAML, read by a validator, or in
        the declared LAUNCH/REMOVED lists. An unknown read is a key a
        typo'd run would silently default — the class of bug
        sanity_check exists to prevent."""
    findings: List[Finding] = []
    config_py = _pkg(ctx, _CONFIG_PY)
    optional = _declared(ctx, config_py, "OPTIONAL_KEYS")
    launch = _declared(ctx, config_py, "LAUNCH_KEYS")
    removed = _declared(ctx, config_py, "REMOVED_KEYS")
    if not optional or not launch:
        return [Finding("VFT002", config_py, 1,
                        "cannot extract OPTIONAL_KEYS/LAUNCH_KEYS from "
                        "config.py — the declared key lists are gone")]
    yaml_union, yaml_common = _yaml_key_sets(ctx)
    vkeys = validator_keys(ctx)

    for key, (rel, line) in sorted(vkeys.items()):
        if key in removed or key in launch:
            continue
        if key not in yaml_common and key not in optional:
            where = "no family YAML" if key not in yaml_union else \
                "only some family YAMLs"
            findings.append(Finding(
                "VFT002", rel, line,
                f"validated config key '{key}' appears in {where} — add "
                f"the default to every configs/*.yml, or declare it in "
                f"config.OPTIONAL_KEYS / LAUNCH_KEYS"))
    # stale declarations
    cfg_anchor = ctx.line_of(config_py, "OPTIONAL_KEYS = ")
    for key in sorted(optional - yaml_union):
        findings.append(Finding(
            "VFT002", config_py, cfg_anchor,
            f"OPTIONAL_KEYS entry '{key}' appears in no family YAML — "
            f"stale declaration", tier=WARN))

    known = yaml_union | set(vkeys) | launch | removed
    for rel, mod in sorted(ctx.package_modules().items()):
        spans = validator_spans(mod)
        for key, line in config_key_reads(mod.tree):
            if key in known:
                continue
            if any(lo <= line <= hi for lo, hi in spans):
                continue  # the validator read IS the declaration
            findings.append(Finding(
                "VFT002", rel, line,
                f"config key '{key}' is read here but declared nowhere: "
                f"not in any configs/*.yml, no validator reads it, and it "
                f"is not in config.LAUNCH_KEYS — a typo'd value would "
                f"silently default"))
    return findings


# -- VFT003: chaos sites -----------------------------------------------------

def _inject_call_sites(ctx: LintContext) -> List[Tuple[str, str, int]]:
    """(site, module, line) for every ``inject.fire("site")`` /
    ``*._inject.check("site")`` call in the package."""
    out: List[Tuple[str, str, int]] = []
    for rel, mod in ctx.package_modules().items():
        if rel == _pkg(ctx, _INJECT_PY):
            continue  # the plan parser mentions sites generically
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("fire", "check")):
                continue
            recv = node.func.value
            recv_name = recv.id if isinstance(recv, ast.Name) else \
                recv.attr if isinstance(recv, ast.Attribute) else ""
            if "inject" not in recv_name:
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.append((node.args[0].value, rel, node.lineno))
    return out


@rule("VFT003", "chaos sites: fire() names registered, every site has a "
                "call site and a docs/chaos.md row")
def check_inject_sites(ctx: LintContext) -> List[Finding]:
    """The fault plane is only as deterministic as its registry: a
    ``fire()`` naming an unregistered site raises at runtime (or worse,
    a plan targeting it fails validation and the drill silently tests
    nothing), and a registered site with no call site is dead chaos
    coverage — the matrix claims to exercise a failure mode it cannot
    reach. The site table in ``docs/chaos.md`` is the operator contract
    and must list every site."""
    findings: List[Finding] = []
    inject_py = _pkg(ctx, _INJECT_PY)
    sites = _declared(ctx, inject_py, "SITES")
    if not sites:
        return [Finding("VFT003", inject_py, 1,
                        "cannot extract SITES from utils/inject.py")]
    calls = _inject_call_sites(ctx)
    called = {s for s, _rel, _line in calls}
    for site, rel, line in calls:
        if site not in sites:
            findings.append(Finding(
                "VFT003", rel, line,
                f"inject site '{site}' is fired here but not registered "
                f"in inject.SITES — plans cannot target it and "
                f"sanity_check would reject them"))
    anchor = ctx.line_of(inject_py, "SITES = ")
    chaos_doc = ctx.read_text("docs/chaos.md") or ""
    documented = set()
    for line_text in chaos_doc.splitlines():
        if line_text.lstrip().startswith("|"):
            documented.update(re.findall(r"`([a-z_]+\.[a-z_]+)`", line_text))
    for site in sorted(sites):
        if site not in called:
            findings.append(Finding(
                "VFT003", inject_py, anchor,
                f"registered inject site '{site}' has no fire()/check() "
                f"call site — dead chaos coverage: the matrix claims a "
                f"failure mode nothing can reach"))
        if site not in documented:
            findings.append(Finding(
                "VFT003", inject_py, anchor,
                f"registered inject site '{site}' has no row in the "
                f"docs/chaos.md site table — the operator contract is "
                f"incomplete"))
    return findings


# -- VFT004: atomic-write discipline -----------------------------------------

#: modules that ARE the sanctioned write paths
_ATOMIC_MODULES = {"telemetry/jsonl.py"}
#: (module, function) pairs that are sanctioned
_ATOMIC_FUNCS = {("utils/sinks.py", "_write_bytes_atomic")}

_WRITE_MODES = re.compile(r"[wax]")


def _open_mode(node: ast.Call) -> Optional[str]:
    args = node.args
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else ""
    idx = 1
    if name == "open" and isinstance(fn, ast.Attribute) and \
            isinstance(fn.value, ast.Name) and fn.value.id == "os":
        return None  # os.open uses flags; covered via the fdopen wrapper
    if name not in ("open", "fdopen"):
        return None
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            return str(kw.value.value)
    if len(args) > idx and isinstance(args[idx], ast.Constant) \
            and isinstance(args[idx].value, str):
        return args[idx].value
    return "r" if name == "open" else None


class _WriteVisitor(ast.NodeVisitor):
    def __init__(self) -> None:
        self.findings: List[Tuple[int, str]] = []
        self._bytesio: List[Set[str]] = [set()]

    def visit_FunctionDef(self, node):  # noqa: N802
        self._bytesio.append(set())
        self.generic_visit(node)
        self._bytesio.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):  # noqa: N802
        value = node.value
        if isinstance(value, ast.Call):
            fn = value.func
            callee = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else ""
            if callee == "BytesIO":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self._bytesio[-1].add(t.id)
        self.generic_visit(node)

    def _first_arg_is_buffer(self, node: ast.Call) -> bool:
        if node.args and isinstance(node.args[0], ast.Name):
            return any(node.args[0].id in scope for scope in self._bytesio)
        return False

    def visit_Call(self, node):  # noqa: N802
        fn = node.func
        callee = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else ""
        mode = _open_mode(node)
        if mode is not None and _WRITE_MODES.search(mode) \
                and "+" not in mode:
            self.findings.append((
                node.lineno,
                f"raw write-mode open(..., {mode!r}): durable artifacts "
                f"must go through utils/sinks._write_bytes_atomic or "
                f"telemetry/jsonl.py (temp+fsync+rename), or carry a "
                f"reasoned suppression"))
        elif callee == "save" and isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in ("np", "numpy") and \
                not self._first_arg_is_buffer(node):
            self.findings.append((
                node.lineno,
                "np.save to a path writes non-atomically: serialize to "
                "BytesIO and route through _write_bytes_atomic"))
        elif callee == "dump" and isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in ("json", "pickle") and \
                len(node.args) > 1 and isinstance(node.args[1], ast.Call):
            self.findings.append((
                node.lineno,
                f"{fn.value.id}.dump into an inline open(): route the "
                f"bytes through _write_bytes_atomic instead"))
        self.generic_visit(node)


@rule("VFT004", "durable artifacts go through the atomic "
                "temp+fsync+rename path")
def check_atomic_writes(ctx: LintContext) -> List[Finding]:
    """Injected ENOSPC/torn/drop faults show that the
    temp+fsync+rename discipline is what keeps a preempted worker from
    leaving half-written artifacts that later readers trust. The
    discipline only holds if every new write site uses it. This rule
    flags raw write-mode opens, path-level ``np.save`` and inline-open
    ``json.dump``/``pickle.dump`` in the package; the sanctioned paths
    (``utils/sinks._write_bytes_atomic``, ``telemetry/jsonl.py``) are
    exempt, and deliberate exceptions (O_EXCL first-writer-wins
    protocol files, verify-then-promote downloads) carry reasoned
    suppressions."""
    findings: List[Finding] = []
    sanctioned_by_mod: Dict[str, Set[str]] = {}
    for mod_rel, func in _ATOMIC_FUNCS:
        sanctioned_by_mod.setdefault(_pkg(ctx, mod_rel), set()).add(func)
    atomic_modules = {_pkg(ctx, m) for m in _ATOMIC_MODULES}
    for rel, mod in sorted(ctx.package_modules().items()):
        if rel in atomic_modules:
            continue
        sanctioned = sanctioned_by_mod.get(rel, set())
        visitor = _WriteVisitor()
        for node in mod.tree.body:
            visitor.visit(node)
        for line, msg in visitor.findings:
            # drop findings inside sanctioned functions
            if sanctioned and _line_in_functions(mod, line, sanctioned):
                continue
            findings.append(Finding("VFT004", rel, line, msg))
    return findings


def _line_in_functions(mod: ParsedModule, line: int,
                       names: Set[str]) -> bool:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name in names and \
                node.lineno <= line <= (node.end_lineno or node.lineno):
            return True
    return False


# -- VFT005: metric-name registry --------------------------------------------

_METRIC_NAME = re.compile(r"^vft_[a-z0-9]+(_[a-z0-9]+)*$")
_METRIC_CALL_ATTRS = {"counter", "gauge", "histogram", "gauge_set", "inc",
                      "observe"}
_METRIC_CALL_NAMES = {"gauge_set", "inc", "observe", "g"}
_KIND_OF_CALL = {"counter": "counter", "inc": "counter",
                 "gauge": "gauge", "gauge_set": "gauge", "g": "gauge",
                 "histogram": "histogram", "observe": "histogram"}


def _metric_callee(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _METRIC_CALL_ATTRS:
        return fn.attr
    if isinstance(fn, ast.Name) and fn.id in _METRIC_CALL_NAMES:
        return fn.id
    return None


def _fstring_pattern(node: ast.JoinedStr) -> Optional[str]:
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(re.escape(str(v.value)))
        else:
            parts.append(r"[a-z0-9_]+")
    pat = "".join(parts)
    first = node.values[0] if node.values else None
    if isinstance(first, ast.Constant) and \
            str(first.value).startswith("vft_"):
        return pat
    return None


@rule("VFT005", "every vft_* metric name resolves against the declared "
                "registry; counters end in _total")
def check_metric_names(ctx: LintContext) -> List[Finding]:
    """74 distinct series names flow from emitters through heartbeats to
    renderers and Prometheus exports — connected only by string
    equality. ``telemetry/names.py`` is the single declared registry;
    every literal (and every f-string a metric call builds) must resolve
    against it, so an emitter rename that forgets a renderer (or vice
    versa) fails the lint instead of silently exporting a dead series.
    Prometheus naming is enforced where it is load-bearing: counters
    end in ``_total``."""
    findings: List[Finding] = []
    names_py = _pkg(ctx, _NAMES_PY)
    names_mod = ctx.module(names_py)
    if names_mod is None:
        return [Finding("VFT005", names_py, 1,
                        "telemetry/names.py (the metric-name registry) "
                        "is missing")]
    registry = ctx.constants(names_py).get("METRICS")
    if not isinstance(registry, dict) or not registry:
        return [Finding("VFT005", names_py, 1,
                        "cannot extract METRICS dict from "
                        "telemetry/names.py")]
    anchor = ctx.line_of(names_py, "METRICS = ")
    for name, kind in sorted(registry.items()):
        if not _METRIC_NAME.match(name):
            findings.append(Finding(
                "VFT005", names_py, anchor,
                f"registry name '{name}' is not a valid vft_* metric "
                f"name"))
        if kind == "counter" and not name.endswith("_total"):
            findings.append(Finding(
                "VFT005", names_py, anchor,
                f"counter '{name}' must end in _total (Prometheus "
                f"counter naming)"))
        if kind not in ("counter", "gauge", "histogram"):
            findings.append(Finding(
                "VFT005", names_py, anchor,
                f"registry entry '{name}' has unknown kind {kind!r}"))

    used: Set[str] = set()
    for rel, mod in sorted(ctx.modules.items()):
        if rel == names_py:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    not mod.is_docstring(node) and \
                    _METRIC_NAME.match(node.value):
                if node.value not in registry:
                    findings.append(Finding(
                        "VFT005", rel, node.lineno,
                        f"metric name '{node.value}' is not declared in "
                        f"telemetry/names.py METRICS — emitter/renderer "
                        f"drift, or a new series missing its "
                        f"registration"))
                else:
                    used.add(node.value)
            elif isinstance(node, ast.Call):
                callee = _metric_callee(node)
                if callee is None or not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.JoinedStr):
                    pat = _fstring_pattern(arg)
                    if pat is None:
                        continue
                    matches = [n for n in registry
                               if re.fullmatch(pat, n)]
                    if not matches:
                        findings.append(Finding(
                            "VFT005", rel, node.lineno,
                            f"dynamically-built metric name (pattern "
                            f"vft_…) matches no registry entry — declare "
                            f"each expansion in telemetry/names.py"))
                    used.update(matches)
                elif isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value in registry:
                    declared = registry[arg.value]
                    expect = _KIND_OF_CALL.get(callee)
                    if expect and declared != expect and callee != "g":
                        findings.append(Finding(
                            "VFT005", rel, node.lineno,
                            f"'{arg.value}' is declared a {declared} but "
                            f"used via .{callee}()"))
    for name in sorted(set(registry) - used):
        findings.append(Finding(
            "VFT005", names_py, anchor,
            f"registry entry '{name}' is referenced nowhere in the "
            f"package or scripts — stale registration", tier=WARN))
    return findings


# -- VFT006: *_FIELDS <-> schema JSON lockstep -------------------------------

def _schema_checks(ctx: LintContext, label: str, schema: Optional[dict],
                   mod_rel: str, consts: Dict[str, Any],
                   fields_name: str, anchor: int,
                   enums: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    fields = consts.get(fields_name)
    if schema is None or fields is None:
        findings.append(Finding(
            "VFT006", mod_rel, anchor,
            f"{label}: cannot load the schema JSON and/or extract "
            f"{fields_name} — the lockstep contract is unverifiable"))
        return findings
    props = set(schema.get("properties", {}))
    want = set(fields)
    for k in sorted(props - want):
        findings.append(Finding(
            "VFT006", mod_rel, anchor,
            f"{label}: schema-only property '{k}' (the emitter never "
            f"writes it) — {fields_name} and the schema JSON drifted"))
    for k in sorted(want - props):
        findings.append(Finding(
            "VFT006", mod_rel, anchor,
            f"{label}: emitter field '{k}' missing from the schema JSON "
            f"properties"))
    for k in sorted(set(schema.get("required", [])) - props):
        findings.append(Finding(
            "VFT006", mod_rel, anchor,
            f"{label}: required key '{k}' is not in properties"))
    if schema.get("additionalProperties", True) is not False:
        findings.append(Finding(
            "VFT006", mod_rel, anchor,
            f"{label}: schema must set additionalProperties: false (the "
            f"record contract is closed)"))
    tag = schema.get("properties", {}).get("schema", {}).get("enum")
    version = consts.get("SCHEMA_VERSION")
    if version is not None and tag != [version]:
        findings.append(Finding(
            "VFT006", mod_rel, anchor,
            f"{label}: schema tag enum {tag} != [{version!r}]"))
    for prop, const in enums.items():
        declared = consts.get(const)
        got = schema.get("properties", {}).get(prop, {}).get("enum")
        if declared is not None and got != list(declared):
            findings.append(Finding(
                "VFT006", mod_rel, anchor,
                f"{label}: '{prop}' enum {got} != {const} "
                f"{list(declared)}"))
    return findings


@rule("VFT006", "*_FIELDS tuples and the checked-in *.schema.json stay "
                "in lockstep")
def check_schema_lockstep(ctx: LintContext) -> List[Finding]:
    """Each telemetry record shape is declared twice on purpose — once
    in code (the emitter's ``*_FIELDS`` tuple) and once as the
    checked-in consumer contract (``*.schema.json``). This rule pins
    the two statically (properties equality, required ⊆ properties,
    closed records, version-tag and status enums), subsuming the static
    halves of the five ``scripts/check_*_schema.py`` CI gates — which
    keep only their dynamic smokes."""
    findings: List[Finding] = []
    tel = _pkg(ctx, "telemetry/")

    def consts_of(rel: str) -> Tuple[Dict[str, Any], int]:
        return ctx.constants(rel), 1

    # spans <-> video_span.schema.json
    rel = tel + "spans.py"
    consts, _ = consts_of(rel)
    findings += _schema_checks(
        ctx, "video_span", ctx.load_json(tel + "video_span.schema.json"),
        rel, consts, "SPAN_FIELDS",
        ctx.line_of(rel, "SPAN_FIELDS = "), {"status": "STATUSES"})

    # health <-> feature_health.schema.json
    rel = tel + "health.py"
    consts, _ = consts_of(rel)
    findings += _schema_checks(
        ctx, "feature_health",
        ctx.load_json(tel + "feature_health.schema.json"),
        rel, consts, "HEALTH_FIELDS",
        ctx.line_of(rel, "HEALTH_FIELDS = "), {})

    # alerts <-> alert.schema.json
    rel = tel + "alerts.py"
    consts, _ = consts_of(rel)
    findings += _schema_checks(
        ctx, "alert", ctx.load_json(tel + "alert.schema.json"),
        rel, consts, "ALERT_FIELDS",
        ctx.line_of(rel, "ALERT_FIELDS = "),
        {"state": "STATES", "severity": "SEVERITIES"})

    # loadgen <-> loadgen_event.schema.json + scenario.schema.json
    # (two record shapes, one emitter module — the journal record and
    # the exit-join verdict artifact; the scenario schema's version tag
    # lives in SCENARIO_SCHEMA, not SCHEMA_VERSION, hence the override)
    rel = _pkg(ctx, "loadgen.py")
    consts, _ = consts_of(rel)
    findings += _schema_checks(
        ctx, "loadgen_event",
        ctx.load_json(tel + "loadgen_event.schema.json"),
        rel, consts, "LOADGEN_FIELDS",
        ctx.line_of(rel, "LOADGEN_FIELDS = "), {"event": "EVENTS"})
    findings += _schema_checks(
        ctx, "scenario", ctx.load_json(tel + "scenario.schema.json"),
        rel, dict(consts, SCHEMA_VERSION=consts.get("SCENARIO_SCHEMA")),
        "SCENARIO_FIELDS", ctx.line_of(rel, "SCENARIO_FIELDS = "),
        {"verdict": "VERDICTS"})

    # parity <-> parity.schema.json + parity_verdict.schema.json
    # (two record shapes, one emitter module — the per-seam digest
    # journal and the certify verdict artifact; the verdict schema's
    # version tag lives in VERDICT_SCHEMA, not SCHEMA_VERSION)
    rel = tel + "parity.py"
    consts, _ = consts_of(rel)
    findings += _schema_checks(
        ctx, "parity", ctx.load_json(tel + "parity.schema.json"),
        rel, consts, "PARITY_FIELDS",
        ctx.line_of(rel, "PARITY_FIELDS = "), {"seam": "SEAMS"})
    findings += _schema_checks(
        ctx, "parity_verdict",
        ctx.load_json(tel + "parity_verdict.schema.json"),
        rel, dict(consts, SCHEMA_VERSION=consts.get("VERDICT_SCHEMA")),
        "VERDICT_FIELDS", ctx.line_of(rel, "VERDICT_FIELDS = "),
        {"verdict": "VERDICTS"})

    # roofline <-> roofline.schema.json (nested)
    rel = tel + "roofline.py"
    consts, _ = consts_of(rel)
    schema = ctx.load_json(tel + "roofline.schema.json")
    anchor = ctx.line_of(rel, "ROOFLINE_FIELDS = ")
    findings += _schema_checks(ctx, "roofline", schema, rel, consts,
                               "ROOFLINE_FIELDS", anchor, {})
    if schema is not None:
        dev = schema.get("properties", {}).get("device", {})
        findings += _schema_checks(ctx, "roofline.device", dev, rel,
                                   dict(consts, SCHEMA_VERSION=None),
                                   "DEVICE_FIELDS", anchor, {})
        fam = schema.get("properties", {}).get("families", {}) \
            .get("additionalProperties", {})
        findings += _schema_checks(ctx, "roofline.family", fam, rel,
                                   dict(consts, SCHEMA_VERSION=None),
                                   "FAMILY_FIELDS", anchor, {})
        card = fam.get("properties", {}).get("programs", {}) \
            .get("items", {})
        findings += _schema_checks(ctx, "roofline.card", card, rel,
                                   dict(consts, SCHEMA_VERSION=None),
                                   "CARD_FIELDS", anchor, {})
        verdicts = consts.get("VERDICTS")
        got = fam.get("properties", {}).get("verdict", {}).get("enum")
        if verdicts is not None and (
                got is None
                or [v for v in got if v is not None] != list(verdicts)):
            findings.append(Finding(
                "VFT006", rel, anchor,
                f"roofline verdict enum {got} != VERDICTS "
                f"{list(verdicts)} (+ null)"))
    return findings


# -- VFT007: unlocked mutation of module globals in threaded modules ---------

_THREADED_MODULES = (
    "serve.py",
    "gateway.py",
    "parallel/queue.py",
    "telemetry/heartbeat.py",
)
_MUTATORS = {"append", "add", "update", "pop", "popleft", "appendleft",
             "extend", "remove", "clear", "setdefault", "insert",
             "discard"}


def _mutable_globals(mod: ParsedModule) -> Set[str]:
    out: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            v = node.value
            if isinstance(v, (ast.List, ast.Dict, ast.Set)):
                out.add(node.targets[0].id)
            elif isinstance(v, ast.Call):
                fn = v.func
                callee = fn.attr if isinstance(fn, ast.Attribute) else \
                    fn.id if isinstance(fn, ast.Name) else ""
                if callee in ("list", "dict", "set", "deque",
                              "defaultdict", "OrderedDict"):
                    out.add(node.targets[0].id)
    return out


class _LockVisitor(ast.NodeVisitor):
    def __init__(self, globals_: Set[str]) -> None:
        self.globals = globals_
        self.findings: List[Tuple[int, str]] = []
        self._with_depth = 0
        self._declared_global: List[Set[str]] = []

    def _locked(self) -> bool:
        return self._with_depth > 0

    def visit_With(self, node):  # noqa: N802
        locked = any("lock" in ast.unparse(item.context_expr).lower()
                     for item in node.items)
        if locked:
            self._with_depth += 1
        self.generic_visit(node)
        if locked:
            self._with_depth -= 1

    def visit_FunctionDef(self, node):  # noqa: N802
        self._declared_global.append(set())
        self.generic_visit(node)
        self._declared_global.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Global(self, node):  # noqa: N802
        if self._declared_global:
            self._declared_global[-1].update(node.names)
        self.generic_visit(node)

    def _flag(self, line: int, name: str, how: str) -> None:
        if not self._locked():
            self.findings.append((
                line, f"module global '{name}' {how} outside a lock-guarded "
                      f"'with' block — this module runs threaded; guard the "
                      f"mutation or make the state thread-local"))

    def visit_Call(self, node):  # noqa: N802
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in self.globals:
            self._flag(node.lineno, fn.value.id, f"mutated via .{fn.attr}()")
        self.generic_visit(node)

    def visit_Subscript(self, node):  # noqa: N802
        if isinstance(node.ctx, (ast.Store, ast.Del)) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in self.globals:
            self._flag(node.lineno, node.value.id, "item-assigned")
        self.generic_visit(node)

    def visit_Assign(self, node):  # noqa: N802
        if self._declared_global:
            for t in node.targets:
                if isinstance(t, ast.Name) and \
                        t.id in self._declared_global[-1] and \
                        t.id in self.globals:
                    self._flag(node.lineno, t.id, "rebound via 'global'")
        self.generic_visit(node)


@rule("VFT007", "module-global mutation in threaded modules happens "
                "under a lock", tier=WARN)
def check_threaded_globals(ctx: LintContext) -> List[Finding]:
    """serve, gateway, the fleet queue and the heartbeat flusher all run
    real threads. A module-level mutable global mutated outside a
    ``with <lock>:`` block is a data race waiting for load. Warn-tier:
    the heuristic cannot see a lock held by the caller, so it flags for
    human review rather than failing the build."""
    findings: List[Finding] = []
    for rel in (_pkg(ctx, m) for m in _THREADED_MODULES):
        mod = ctx.module(rel)
        if mod is None:
            continue
        globals_ = _mutable_globals(mod)
        if not globals_:
            continue
        visitor = _LockVisitor(globals_)
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                visitor.visit(node)
        for line, msg in visitor.findings:
            findings.append(Finding("VFT007", rel, line, msg, tier=WARN))
    return findings
