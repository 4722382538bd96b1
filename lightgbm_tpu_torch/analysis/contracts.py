"""Contract linters: knob, metric-name and artifact-write discipline
(the JAX package's ``analysis/contracts.py``, over the port's files).

Three contracts of the port's code:

**Knobs** — every ``tpu_*`` knob used anywhere (attribute read,
``params.get("tpu_x")``, dict key) must be

- *declared*: a ``Config`` dataclass field (the port's ``config.py``);
- *documented*: present in ``docs/Parameters.md`` (the JAX package's
  generated table, which the port's knobs share; read only);
- *validated*: int/float knobs must be referenced by
  ``Config.check_param_conflict`` (the validation seam), directly or
  through a module-level table of knob names it reads — free-domain
  knobs are baselined with a justification;
- *classified* w.r.t. ``utils/checkpoint.py VOLATILE_KNOBS``: every
  VOLATILE entry must name a live Config field, and a knob whose
  reads are confined to telemetry/tooling modules must be VOLATILE —
  otherwise changing a port or a path silently invalidates every old
  checkpoint's config fingerprint.

**Metrics** — every obs metric name (``obs.counter("...")`` etc.)
must match the naming scheme ``group/name[/sub]`` (lowercase,
``[a-z0-9_]``). A NON-constant name is a label-cardinality hazard
(every distinct string becomes a new time series) and must carry a
``# bounded-cardinality: <reason>`` annotation.

**Artifacts** — run artifacts written by obs/ and utils/ must
route through ``utils/fileio.atomic_write`` (the one tmp+rename
implementation): a bare ``open(path, "w")`` there can leave a torn
file for a concurrent reader. Append-mode streams (JSONL time series)
are the designed exception; ``fileio.py`` itself is the
implementation. Waive a deliberate site with ``# atomic-ok: reason``.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import PACKAGE, Finding, SourceFile, call_name, dotted, \
    enclosing_stmt

CHECKER = "contracts"

_KNOB_RE = re.compile(r"^tpu_[a-z0-9_]+$")
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(/[a-z0-9_]+)*$")
_BOUNDED_RE = re.compile(r"bounded-cardinality:\s*(\S.*)")
_ATOMIC_OK_RE = re.compile(r"atomic-ok:\s*(\S.*)")
_DOC_KNOB_RE = re.compile(r"\|\s*`(tpu_[a-z0-9_]+)`")

METRIC_FACTORY_NAMES = {"counter", "gauge", "timer", "histogram",
                        "latency_histogram"}
# knob-string consumers: a "tpu_x" literal inside these calls is a read
KNOB_STRING_CALLS = {"get", "getattr", "config_get", "pop",
                     "setdefault"}
# modules whose knob reads cannot alter training math: a knob read
# ONLY from here belongs in VOLATILE_KNOBS (fingerprint stability)
TELEMETRY_PREFIXES = (f"{PACKAGE}/obs/",)
TELEMETRY_FILES = (f"{PACKAGE}/utils/timing.py", f"{PACKAGE}/utils/log.py")
# artifact-write scope of the atomic-write rule
ATOMIC_SCOPE_PREFIXES = (f"{PACKAGE}/obs/", f"{PACKAGE}/utils/")
ATOMIC_IMPL = f"{PACKAGE}/utils/fileio.py"
CONFIG_FILE = f"{PACKAGE}/config.py"
CHECKPOINT_FILE = f"{PACKAGE}/utils/checkpoint.py"
REGISTRY_FILE = f"{PACKAGE}/obs/registry.py"


@dataclass
class RepoInfo:
    """Facts about the repo's contract surfaces, parsed (never
    imported) from their single-source-of-truth files."""
    config_fields: Set[str] = field(default_factory=set)
    validated_knobs: Set[str] = field(default_factory=set)
    volatile_knobs: Set[str] = field(default_factory=set)
    documented_knobs: Set[str] = field(default_factory=set)
    # pre-rename knobs accepted with a deprecation warning
    # (config.py DEPRECATED_ALIASES keys): legitimately used without
    # being dataclass fields
    deprecated_aliases: Set[str] = field(default_factory=set)


def build_repo_info(sources: List[SourceFile],
                    root: str) -> RepoInfo:
    info = RepoInfo()
    for sf in sources:
        if sf.rel == CONFIG_FILE:
            _parse_config(sf, info)
        elif sf.rel == CHECKPOINT_FILE:
            _parse_volatile(sf, info)
    params_md = os.path.join(root, "docs", "Parameters.md")
    if os.path.exists(params_md):
        with open(params_md, encoding="utf-8") as fh:
            info.documented_knobs = set(_DOC_KNOB_RE.findall(fh.read()))
    return info


def _parse_config(sf: SourceFile, info: RepoInfo) -> None:
    # module-level tables of knob names (the port validates its knobs
    # table-driven): a table that check_param_conflict reads validates
    # the knobs it names
    tables: Dict[str, Set[str]] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            names = {n.value for n in ast.walk(node.value)
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str) and _KNOB_RE.match(n.value)}
            for t in node.targets:
                if isinstance(t, ast.Name) and names:
                    tables[t.id] = names
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    info.config_fields.add(stmt.target.id)
                if isinstance(stmt, ast.FunctionDef) and \
                        stmt.name == "check_param_conflict":
                    for n in ast.walk(stmt):
                        if isinstance(n, ast.Attribute) and \
                                _KNOB_RE.match(n.attr):
                            info.validated_knobs.add(n.attr)
                        elif isinstance(n, ast.Constant) and \
                                isinstance(n.value, str) and \
                                _KNOB_RE.match(n.value):
                            info.validated_knobs.add(n.value)
                        elif isinstance(n, ast.Name) and n.id in tables:
                            info.validated_knobs |= tables[n.id]
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "DEPRECATED_ALIASES"
                for t in node.targets) and \
                isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str):
                    info.deprecated_aliases.add(k.value)


def _parse_volatile(sf: SourceFile, info: RepoInfo) -> None:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "VOLATILE_KNOBS"
                for t in node.targets):
            for n in ast.walk(node.value):
                if isinstance(n, ast.Constant) and \
                        isinstance(n.value, str):
                    info.volatile_knobs.add(n.value)


# ---------------------------------------------------------------------------
# Knob linter
# ---------------------------------------------------------------------------

def _knob_uses(sf: SourceFile) -> List[Tuple[str, int]]:
    """(knob, line) for every tpu_* use in one file: attribute
    reads/writes (``cfg.tpu_x`` — never the func of a call, so
    ``autotune.tpu_compiler_params()`` is not a knob), knob-string
    arguments of get/getattr/config_get, dict-literal keys,
    subscripts and comparisons."""
    uses: List[Tuple[str, int]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute) and _KNOB_RE.match(node.attr):
            parent = sf.parent(node)
            if isinstance(parent, ast.Call) and parent.func is node:
                continue                # a tpu_*-named function, not a knob
            uses.append((node.attr, node.lineno))
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and _KNOB_RE.match(node.value):
            parent = sf.parent(node)
            if isinstance(parent, ast.Call):
                fname = call_name(parent).rsplit(".", 1)[-1]
                if fname in KNOB_STRING_CALLS and \
                        node in parent.args:
                    uses.append((node.value, node.lineno))
            elif isinstance(parent, ast.Dict):
                if node in parent.keys:
                    uses.append((node.value, node.lineno))
            elif isinstance(parent, (ast.Subscript, ast.Compare)):
                uses.append((node.value, node.lineno))
    return uses


def check_knobs(sources: List[SourceFile], info: RepoInfo
                ) -> List[Finding]:
    out: List[Finding] = []
    reads_by_knob: Dict[str, Set[str]] = {}
    first_use: Dict[str, Tuple[str, int]] = {}
    for sf in sources:
        for knob, line in _knob_uses(sf):
            reads_by_knob.setdefault(knob, set()).add(sf.rel)
            first_use.setdefault(knob, (sf.rel, line))
            if knob not in info.config_fields and \
                    knob not in info.deprecated_aliases:
                out.append(Finding(
                    CHECKER, "undeclared-knob", sf.rel, line,
                    f"{knob!r} is used here but is not a Config "
                    "dataclass field — declare (and validate) it in "
                    "config.py", f"{knob}"))
    for knob in sorted(k for k in info.config_fields
                       if _KNOB_RE.match(k)):
        if knob not in info.documented_knobs:
            out.append(Finding(
                CHECKER, "undocumented-knob", CONFIG_FILE, 1,
                f"{knob!r} is declared but missing from "
                "docs/Parameters.md", f"{knob}"))
    # VOLATILE classification
    for name in sorted(info.volatile_knobs):
        if name not in info.config_fields:
            out.append(Finding(
                CHECKER, "stale-volatile-entry", CHECKPOINT_FILE, 1,
                f"VOLATILE_KNOBS entry {name!r} is not a Config "
                "field — a renamed/removed knob left the "
                "fingerprint exclusion behind", f"{name}"))
    for knob, where in sorted(reads_by_knob.items()):
        if knob not in info.config_fields or knob in info.volatile_knobs:
            continue
        semantic = [w for w in where
                    if not (w.startswith(TELEMETRY_PREFIXES)
                            or w in TELEMETRY_FILES
                            or w == CONFIG_FILE)]
        if not semantic:
            rel, line = first_use[knob]
            out.append(Finding(
                CHECKER, "unclassified-telemetry-knob", rel, line,
                f"{knob!r} is read only from telemetry/tooling "
                f"({', '.join(sorted(where))}) but is NOT in "
                "VOLATILE_KNOBS — changing it would invalidate every "
                "old checkpoint's config fingerprint", f"{knob}"))
    return out


def check_knob_validation(sources: List[SourceFile], info: RepoInfo
                          ) -> List[Finding]:
    """Int/float tpu_* fields must be touched by check_param_conflict
    (bools are validated by parsing; strings case-by-case)."""
    out: List[Finding] = []
    for sf in sources:
        if sf.rel != CONFIG_FILE:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name == "Config"):
                continue
            for stmt in node.body:
                if not (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    continue
                knob = stmt.target.id
                if not _KNOB_RE.match(knob):
                    continue
                ann = dotted(stmt.annotation)
                if ann not in ("int", "float"):
                    continue
                if knob in info.validated_knobs:
                    continue
                out.append(Finding(
                    CHECKER, "unvalidated-knob", sf.rel, stmt.lineno,
                    f"{knob!r} ({ann}) is never referenced by "
                    "Config.check_param_conflict — a bad value flows "
                    "straight to the consumer; add a clamp/warning "
                    "(or baseline with why the full domain is valid)",
                    f"{knob}"))
    return out


# ---------------------------------------------------------------------------
# Metric-name linter
# ---------------------------------------------------------------------------

def check_metrics(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if sf.rel == REGISTRY_FILE:
            continue                    # the factory itself
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = call_name(node).rsplit(".", 1)[-1]
            if fname not in METRIC_FACTORY_NAMES:
                continue
            base = call_name(node)
            if "." in base and not _looks_like_obs(base):
                continue                # e.g. collections.Counter-ish
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str):
                if not _METRIC_NAME_RE.match(arg.value):
                    out.append(Finding(
                        CHECKER, "metric-name", sf.rel, node.lineno,
                        f"metric name {arg.value!r} does not match "
                        "the scheme group/name ([a-z0-9_] segments "
                        "joined by '/')", f"{arg.value}"))
            else:
                covered = (_BOUNDED_RE.search(sf.comment_near(node))
                           or _BOUNDED_RE.search(sf.comment_near(
                               enclosing_stmt(sf, node))))
                if not covered:
                    # a function-level annotation (above its def)
                    # covers every dynamic name inside that function
                    for fn in sf.enclosing_functions(node):
                        if _BOUNDED_RE.search(sf.comment_near(fn)):
                            covered = True
                            break
                if covered:
                    continue
                expr = ast.unparse(arg)
                out.append(Finding(
                    CHECKER, "metric-cardinality", sf.rel, node.lineno,
                    f"metric name is dynamic ({expr[:48]}) — every "
                    "distinct string becomes a new time series; "
                    "annotate the bounded label set with "
                    "'# bounded-cardinality: reason' or use a "
                    "constant name",
                    f"{sf.qualname(enclosing_stmt(sf, node))}:"
                    f"{expr[:48]}"))
    return out


def _looks_like_obs(base: str) -> bool:
    head = base.split(".", 1)[0]
    return head in ("obs", "_obs", "registry", "self") or \
        "registry" in base or "obs" in head


# ---------------------------------------------------------------------------
# Artifact-write linter
# ---------------------------------------------------------------------------

def check_artifacts(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if not sf.rel.startswith(ATOMIC_SCOPE_PREFIXES):
            continue
        if sf.rel == ATOMIC_IMPL:
            continue                    # the tmp+rename implementation
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) != "open":
                continue
            mode = _open_mode(node)
            if mode is None or "w" not in mode:
                continue
            if _ATOMIC_OK_RE.search(sf.comment_near(node)) or \
                    _ATOMIC_OK_RE.search(sf.comment_near(
                        enclosing_stmt(sf, node))):
                continue
            out.append(Finding(
                CHECKER, "non-atomic-write", sf.rel, node.lineno,
                f"bare open(..., {mode!r}) in the artifact scope — a "
                "concurrent reader can observe a torn file; route "
                "through utils/fileio.atomic_write (or waive with "
                "'# atomic-ok: reason')",
                f"{sf.qualname(enclosing_stmt(sf, node))}:{mode}"))
    return out


def _open_mode(call: ast.Call) -> Optional[str]:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def check(sources: List[SourceFile], info: RepoInfo) -> List[Finding]:
    return (check_knobs(sources, info)
            + check_knob_validation(sources, info)
            + check_metrics(sources)
            + check_artifacts(sources))
