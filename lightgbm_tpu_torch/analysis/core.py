"""Shared infrastructure of the port's static-analysis checkers (the JAX
package's ``analysis/core.py``, pointed at ``lightgbm_tpu_torch/``).

Everything here is standard library only (``ast``, ``symtable``,
``tokenize``), so the analysis runs without importing the package under
analysis: no torch, no device, no side effects. A
``SourceFile`` is parsed once and shared by every checker; findings
carry a line for humans and a line-independent ``key`` for the
baseline file (keys must survive unrelated edits, so they hash the
enclosing symbol, not the line number).
"""
from __future__ import annotations

import ast
import io
import json
import os
import symtable
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# checkers whose baselines must stay EMPTY: values a CUDA graph freezes
# (capture) and the serving locks' races (lock_discipline). A deliberate
# exemption for these goes INLINE next to the code as an annotated
# waiver with a reason — never silently into the baseline file.
NO_BASELINE_CHECKERS = ("capture", "lock_discipline")

# the scanned package and the baseline file, relative to the repo root
PACKAGE = "lightgbm_tpu_torch"
BASELINE_PATH = f"{PACKAGE}/analysis/baseline.json"
# the port's scripts at the repo's root, scanned with the package
ROOT_SCRIPTS = ("chip_smoke.py", "f32_plan_sweep.py", "int8_plan_sweep.py")

BASELINE_VERSION = 1


class UsageError(Exception):
    """Driver-level misuse (bad baseline file, bad arguments) —
    ``python -m lightgbm_tpu_torch.analysis`` maps this to exit code 2."""


@dataclass(frozen=True)
class Finding:
    checker: str        # e.g. "capture"
    rule: str           # e.g. "nonstatic-capture"
    path: str           # repo-relative posix path
    line: int           # 1-based, for humans (not part of the key)
    message: str
    detail: str         # line-stable discriminator (symbol, name, ...)

    @property
    def key(self) -> str:
        return f"{self.checker}:{self.rule}:{self.path}:{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
                f"{self.message}")

    def to_json(self) -> dict:
        return {"checker": self.checker, "rule": self.rule,
                "path": self.path, "line": self.line,
                "message": self.message, "detail": self.detail,
                "key": self.key}


# ---------------------------------------------------------------------------
# Baseline file
# ---------------------------------------------------------------------------

@dataclass
class Baseline:
    """Checked-in exemption list (``BASELINE_PATH``).

    Every entry carries a one-line justification; entries that no
    longer match any live finding are reported as STALE (so the file
    can only shrink toward zero, never rot). Entries for the
    NO_BASELINE_CHECKERS are refused at load."""

    path: str = ""
    entries: Dict[str, str] = field(default_factory=dict)   # key -> why

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            raise UsageError(f"unreadable baseline {path}: {e}")
        if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
            raise UsageError(
                f"baseline {path}: expected a dict with version="
                f"{BASELINE_VERSION}, got {type(doc).__name__} "
                f"version={doc.get('version') if isinstance(doc, dict) else '?'}")
        entries: Dict[str, str] = {}
        for i, e in enumerate(doc.get("entries", [])):
            if (not isinstance(e, dict) or not isinstance(e.get("key"), str)
                    or not isinstance(e.get("justification"), str)
                    or not e.get("justification").strip()):
                raise UsageError(
                    f"baseline {path}: entry {i} needs string 'key' and a "
                    "non-empty 'justification'")
            checker = e["key"].split(":", 1)[0]
            if checker in NO_BASELINE_CHECKERS:
                raise UsageError(
                    f"baseline {path}: entry {i} ({e['key']}) — "
                    f"{checker} findings cannot be baselined; fix the "
                    "code or add an inline annotated waiver with a reason")
            if e["key"] in entries:
                raise UsageError(
                    f"baseline {path}: duplicate key {e['key']}")
            entries[e["key"]] = e["justification"]
        return cls(path=path, entries=entries)

    def apply(self, findings: List[Finding]
              ) -> Tuple[List[Finding], int, List[str]]:
        """(kept findings, suppressed count, stale baseline keys)."""
        used = set()
        kept = []
        for f in findings:
            if f.key in self.entries:
                used.add(f.key)
            else:
                kept.append(f)
        stale = [k for k in self.entries if k not in used]
        return kept, len(used), stale

    def dump(self, findings: List[Finding]) -> dict:
        """Document for --update-baseline (justifications to fill in;
        NO_BASELINE_CHECKERS findings are never written)."""
        entries = []
        for f in sorted(findings, key=lambda f: f.key):
            if f.checker in NO_BASELINE_CHECKERS:
                continue
            entries.append({"key": f.key,
                            "justification": self.entries.get(
                                f.key, "TODO: justify or fix"),
                            "note": f.message})
        return {"version": BASELINE_VERSION, "entries": entries}


# ---------------------------------------------------------------------------
# Parsed source files
# ---------------------------------------------------------------------------

class SourceFile:
    """One parsed module: AST with parent links, per-line comments,
    lazily-built symtable. Checkers share one instance per file."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._parent = parent  # type: ignore[attr-defined]
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:      # pragma: no cover - parse ok above
            pass
        self._symtable: Optional[symtable.SymbolTable] = None

    # -- navigation ---------------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_parent", None)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_functions(self, node: ast.AST
                            ) -> List[ast.AST]:
        """Innermost-first chain of enclosing FunctionDef/Lambda."""
        return [a for a in self.ancestors(node)
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))]

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def qualname(self, node: ast.AST) -> str:
        """Dotted path of enclosing defs/classes — the line-stable
        symbol findings key on."""
        parts = []
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                parts.append(a.name)
        name = getattr(node, "name", None)
        if isinstance(name, str):
            parts.insert(0, name)
        return ".".join(reversed(parts)) or "<module>"

    # -- comments / waivers -------------------------------------------------

    def comment_near(self, node: ast.AST) -> str:
        """Trailing comment on the node's first line plus any
        comment-only lines directly above it — where annotation
        waivers live."""
        line = getattr(node, "lineno", 0)
        parts = []
        above = line - 1
        while above in self.comments and \
                self.lines[above - 1].lstrip().startswith("#"):
            parts.append(self.comments[above])
            above -= 1
        parts.reverse()
        if line in self.comments:
            parts.append(self.comments[line])
        # strip the leading hashes so an annotation spanning several
        # comment lines parses as one text (ok(a, b,\n#  c) — ...)
        return " ".join(p.lstrip("#").strip() for p in parts)

    # -- symtable -----------------------------------------------------------

    def function_table(self, node: ast.AST
                       ) -> Optional[symtable.SymbolTable]:
        """The symtable block for a FunctionDef/Lambda node (matched
        by name + line)."""
        if self._symtable is None:
            self._symtable = symtable.symtable(self.text, self.rel,
                                               "exec")
        want_line = getattr(node, "lineno", None)
        want_name = getattr(node, "name", "lambda")

        def walk(tab: symtable.SymbolTable):
            for child in tab.get_children():
                if (child.get_lineno() == want_line
                        and child.get_name() == want_name):
                    return child
                found = walk(child)
                if found is not None:
                    return found
            return None

        return walk(self._symtable)

    def free_names(self, node: ast.AST) -> List[str]:
        """Free variables of a function node (captured from enclosing
        function scopes; module globals and builtins are NOT free)."""
        tab = self.function_table(node)
        if tab is None:                  # pragma: no cover - defensive
            return []
        if isinstance(tab, symtable.Function):
            return sorted(tab.get_frees())
        return []


def iter_sources(root: str) -> List[SourceFile]:
    """The analysis scan set: the port's package and its scripts at the
    repo's root. Tests and fixtures are deliberately excluded —
    synthetic rule-violation fixtures live there."""
    paths: List[str] = []
    pkg = os.path.join(root, PACKAGE)
    for base, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("__pycache__", "_build"))
        for f in sorted(files):
            if f.endswith(".py"):
                paths.append(os.path.join(base, f))
    for f in ROOT_SCRIPTS:
        p = os.path.join(root, f)
        if os.path.exists(p):
            paths.append(p)
    out = []
    for p in paths:
        with open(p, encoding="utf-8") as fh:
            text = fh.read()
        out.append(SourceFile(p, os.path.relpath(p, root), text))
    return out


# ---------------------------------------------------------------------------
# Small AST predicates shared by checkers
# ---------------------------------------------------------------------------

def call_name(call: ast.Call) -> str:
    """Dotted name of a call target: ``torch.cuda.synchronize`` for
    ``torch.cuda.synchronize()``, ``get_step`` for ``get_step(...)``."""
    return dotted(call.func)


def dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def enclosing_stmt(sf: "SourceFile", node: ast.AST) -> ast.AST:
    """The statement-level ancestor of ``node`` (direct child of the
    enclosing def/class/module) — what findings key their qualname
    on, shared so sibling checkers emit identical keys."""
    cur = node
    for a in sf.ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Module)):
            return cur
        cur = a
    return cur
