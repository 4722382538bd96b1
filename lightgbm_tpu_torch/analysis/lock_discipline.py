"""lock-discipline checker: annotated shared state is written under
its lock (the JAX package's ``analysis/lock_discipline.py``).

The port carries locks across serving, the registries, ingest and obs
whose discipline — which attribute is guarded by which lock — is a
convention; this checker makes it machine-checked:

**Declaring**: annotate the attribute's initialization with a trailing
comment naming the lock (an attribute on the same object for instance
state, a module global for module state)::

    self._pending = None          # guarded-by: _join_lock
    _steps = OrderedDict()        # guarded-by: _lock

A lock HELPER is declared with call syntax and matches a ``with`` on
that call::

    self._stacked_cache = None    # guarded-by: _stacked_guard()

**Checking**: every write to an annotated attribute anywhere in the
same class (any method) or module must be lexically inside a matching
``with`` block. Writes are assignments, item/attr stores through the
attribute, ``del``, augmented assignment, and calls of known mutator
methods (``append``/``update``/``pop``/``clear``/...). Reads are NOT
checked — the convention proves write discipline (readers that need a
consistent snapshot take the lock by code review, as documented at
each declaration).

**Exemptions** (each is a happens-before argument, not a hole):

- writes inside ``__init__`` / module top level — publication of the
  owning object happens-before any other thread can hold a reference;
- functions annotated ``# guarded-by: <lock>`` on their ``def`` line
  declare "called with <lock> held" — their bodies count as guarded,
  and every intra-class/module CALL SITE of such a function is
  checked to be inside the ``with`` instead;
- a single write site can be waived with ``# unguarded-ok: <reason>``.

Like the capture checker's, this checker's baseline must stay empty:
exemptions live next to the code.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, SourceFile, dotted, enclosing_stmt

CHECKER = "lock_discipline"

_DECL_RE = re.compile(r"guarded-by:\s*([A-Za-z_][\w.]*(?:\(\))?)")
_WAIVE_RE = re.compile(r"unguarded-ok:\s*(\S.*)")

MUTATOR_METHODS = {
    "append", "appendleft", "add", "clear", "pop", "popitem",
    "popleft", "update", "move_to_end", "setdefault", "extend",
    "extendleft", "remove", "insert", "discard", "sort", "reverse",
}


@dataclass(frozen=True)
class _Decl:
    scope: str          # class name for self.X, "<module>" for globals
    attr: str
    lock: str           # "_join_lock" or "_stacked_guard()"


def _scope_name(sf: SourceFile, node: ast.AST) -> str:
    cls = sf.enclosing_class(node)
    return cls.name if cls is not None else "<module>"


def _collect_decls(sf: SourceFile) -> Dict[Tuple[str, str], _Decl]:
    decls: Dict[Tuple[str, str], _Decl] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        # the annotation may trail the assignment's first line OR sit
        # on its own comment line directly above (long declarations)
        m = _DECL_RE.search(sf.comment_near(node))
        if m is None:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            attr = _target_attr(t)
            if attr is None:
                continue
            scope = _scope_name(sf, node)
            decls[(scope, attr)] = _Decl(scope, attr, m.group(1))
    return decls


def _target_attr(t: ast.AST) -> Optional[str]:
    """'_pending' for ``self._pending``; '_steps' for module ``_steps``."""
    if isinstance(t, ast.Attribute) and \
            isinstance(t.value, ast.Name) and t.value.id == "self":
        return t.attr
    if isinstance(t, ast.Name):
        return t.id
    return None


def _held_locks(sf: SourceFile, node: ast.AST) -> Set[str]:
    """Lock specs lexically held at ``node``: from enclosing ``with``
    items plus any guarded-by annotation on enclosing ``def`` lines
    (the called-with-lock-held convention)."""
    held: Set[str] = set()
    for a in sf.ancestors(node):
        if isinstance(a, (ast.With, ast.AsyncWith)):
            for item in a.items:
                spec = _lock_spec(item.context_expr)
                if spec:
                    held.add(spec)
        elif isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m = _DECL_RE.search(sf.comment_near(a))
            if m is not None:
                held.add(m.group(1))
    return held


def _lock_spec(expr: ast.AST) -> str:
    """Canonical spec of a with-item: ``self._join_lock`` ->
    '_join_lock'; ``self._stacked_guard()`` -> '_stacked_guard()';
    module ``_lock`` -> '_lock'."""
    if isinstance(expr, ast.Call) and not expr.args \
            and not expr.keywords:
        inner = _lock_spec(expr.func)
        return f"{inner}()" if inner else ""
    d = dotted(expr)
    if d.startswith("self."):
        d = d[len("self."):]
    return d


def _rebinds_global(sf: SourceFile, node: ast.AST, name: str) -> bool:
    """True when a plain ``name = ...`` at ``node`` rebinds the module
    global: at module top level, or inside a function that declares
    ``global name``."""
    fns = sf.enclosing_functions(node)
    if not fns:
        return True
    for fn in fns:
        for n in ast.walk(fn):
            if isinstance(n, ast.Global) and name in n.names:
                return True
    return False


def _is_init_exempt(sf: SourceFile, node: ast.AST) -> bool:
    fns = sf.enclosing_functions(node)
    if not fns:
        return True                     # module top level
    # the attribute owner's constructor: no other thread can hold a
    # reference yet (publication happens-before thread start)
    return getattr(fns[0], "name", "") == "__init__"


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        decls = _collect_decls(sf)
        if not decls:
            continue
        guarded_fns = _guarded_functions(sf)
        for node in ast.walk(sf.tree):
            for attr, is_self, write_kind in _writes(node):
                # self.X binds to the enclosing class's declaration;
                # a bare name is a module global wherever it is
                # written from
                scope = (_scope_name(sf, node) if is_self
                         else "<module>")
                decl = decls.get((scope, attr))
                if decl is None:
                    continue
                if not is_self and write_kind == "write" and \
                        not _rebinds_global(sf, node, attr):
                    # a plain rebinding of a bare name inside a
                    # function WITHOUT `global` is a new local (it
                    # can never touch the module global) — only
                    # item/mutator writes reach the global unadorned
                    continue
                line = getattr(node, "lineno", 0)
                comment = sf.comment_near(node)
                if _DECL_RE.search(comment):
                    continue            # the declaration site itself
                if _WAIVE_RE.search(comment):
                    continue
                if _is_init_exempt(sf, node):
                    continue
                if decl.lock in _held_locks(sf, node):
                    continue
                qual = sf.qualname(node if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    else enclosing_stmt(sf, node))
                out.append(Finding(
                    CHECKER, "unguarded-write", sf.rel, line,
                    f"{write_kind} of {scope}.{attr} outside "
                    f"'with {decl.lock}' (declared guarded-by at its "
                    "init; waive a deliberate site with "
                    "'# unguarded-ok: reason')",
                    f"{qual}:{attr}"))
        # call sites of guarded functions must hold the lock
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = _callee_simple(node)
            lock = guarded_fns.get((_scope_name(sf, node), callee))
            if lock is None:
                continue
            if lock in _held_locks(sf, node):
                continue
            if _WAIVE_RE.search(sf.comments.get(node.lineno, "")):
                continue
            out.append(Finding(
                CHECKER, "unguarded-call", sf.rel, node.lineno,
                f"call of {callee}() outside 'with {lock}' — the "
                "callee is annotated guarded-by (its body assumes "
                "the lock is held)",
                f"{sf.qualname(enclosing_stmt(sf, node))}:{callee}"))
    return out


def _guarded_functions(sf: SourceFile) -> Dict[Tuple[str, str], str]:
    """(scope, fn name) -> lock spec, for defs annotated guarded-by."""
    out: Dict[Tuple[str, str], str] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m = _DECL_RE.search(sf.comment_near(node))
            if m is not None:
                out[(_scope_name(sf, node), node.name)] = m.group(1)
    return out


def _callee_simple(call: ast.Call) -> str:
    d = dotted(call.func)
    if d.startswith("self."):
        d = d[len("self."):]
    return d


def _writes(node: ast.AST):
    """Yield (attr, kind) for write-shaped uses in ``node`` (one
    statement-level AST node at a time via the caller's walk)."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from _target_writes(t)
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        yield from _target_writes(node.target)
    elif isinstance(node, ast.AugAssign):
        yield from _target_writes(node.target)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            yield from _target_writes(t)
    elif isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS:
            attr = _target_attr(node.func.value)
            if attr is not None:
                yield (attr, _is_self_ref(node.func.value),
                       f"mutating call (.{node.func.attr})")


def _is_self_ref(t: ast.AST) -> bool:
    return isinstance(t, ast.Attribute)


def _target_writes(t: ast.AST):
    attr = _target_attr(t)
    if attr is not None:
        yield attr, _is_self_ref(t), "write"
        return
    # item/attr store THROUGH the annotated name: self._pending["k"]=v
    if isinstance(t, (ast.Subscript, ast.Attribute)):
        inner = _target_attr(t.value)
        if inner is not None:
            yield inner, _is_self_ref(t.value), "item write"
    if isinstance(t, (ast.Tuple, ast.List)):
        for elt in t.elts:
            yield from _target_writes(elt)
