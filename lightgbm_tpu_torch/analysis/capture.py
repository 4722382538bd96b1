"""capture checker: a CUDA graph freezes what its function closes over.

The port replays CUDA graphs where the JAX package replays compiled
programs: a serving graph per model and tree range
(``ops/stacked_predict.py _replay``) and a wave graph per width of a
step-cache state (``ops/wave_grower.py WaveState.run_wave``), both
recorded by ``utils/device.py capture_graph``. A graph bakes in every
address and every scalar its function used while it recorded, so a value
that differs at a later replay is silently the old one: a graph of one
tree range replayed for another, a state's graph reading one booster's
per-tree tensor after another's took the state. The CPU never captures,
so no CPU test sees the class; this checker moves it to analysis time.
It is the torch meaning of the JAX package's ``analysis/jit_capture.py``.

**Sites.** The function handed to ``capture_graph`` (its first argument)
or to ``run_wave`` (its second): a lambda, a local ``def``, or a local
name bound to a lambda. A ``capture_graph`` call that forwards a
parameter of a capture entry point (``run_wave``'s own ``fn``) is
audited at that entry point's call sites.

**What it may close over** (each free name; nested local functions it
reaches are audited the same way, transitively):

- the names that make up the key of the dict the graph is stored in:
  the subscript of ``graphs[key] = capture_graph(...)`` and the names
  of that key's binding (``rng = (first, ntree)``), or ``run_wave``'s
  first argument (the width ``k``); a different value is a different
  graph;
- the leased state's or the memo entry's static tensors: a name bound
  by a call of ``keep``, ``padded``, ``load``, ``feature_mask`` or
  ``staging`` (the state's and the entry's persistent buffers, whose
  addresses outlive the capture), by a local function that returns one,
  or by a container or index of them;
- the static kinds the JAX checker allows: module globals and builtins,
  constants, ``int()/float()/bool()/len()/tuple()/...`` results,
  arithmetic and comparisons over statics (not over tensors: those make
  a new tensor each call), ``Config`` fields, and also
  a tensor's ``device``/``dtype``/``shape``/``ndim`` and the attributes
  of an imported module (``torch.int32``).

A parameter of an enclosing function is a per-call value, which a graph
that outlives the call freezes: it must be in the key, or waived. The
binding that counts is the last one before the capture site (a name
rebound after the captures does not reach them).

**Host syncs** inside a captured function (and the same class's methods
it calls) are findings: ``.item()``, ``.cpu()``, ``.numpy()``,
``.tolist()``, ``.synchronize()``, ``bool()/int()/float()`` of a tensor,
``if``/``while``/``assert`` on a tensor, ``nonzero()`` without
``size=`` and the one-argument ``torch.where``. A capture refuses them
on the card, or a replay skips the host's side of them.

**Waivers** are inline, next to the code, with a reason, on the
function's ``def`` (or lambda's line), the site or the statement::

    # capture: ok(self) — the graph is kept in this model's memo

``ok(sync)`` waives the host syncs of that function. The checker's
baseline must stay empty.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile, call_name, dotted

CHECKER = "capture"

# call name -> position of the captured function among its arguments
CAPTURE_CALLS = {"capture_graph": 0, "run_wave": 1}
# calls that return the leased state's or the memo entry's persistent
# tensors
STATE_PROVIDERS = {"keep", "padded", "load", "feature_mask", "staging"}
STATIC_ATTRS = {"device", "dtype", "shape", "ndim"}
STATIC_CALL_NAMES = {
    "int", "float", "bool", "str", "len", "min", "max", "round",
    "abs", "tuple", "sorted", "range", "frozenset", "repr", "hash",
}
STATIC_METHOD_NAMES = {"bit_length"}
SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
# tensor methods whose result is a tensor (a test on it reads it back)
TENSOR_METHODS = {"any", "all", "sum", "max", "min", "mean", "prod",
                  "eq", "ne", "gt", "lt", "ge", "le", "isfinite", "isnan",
                  "count_nonzero"}

_WAIVER_RE = re.compile(
    r"capture:\s*ok\(([^)]*)\)\s*[-—:]*\s*(.*?)(?=capture:\s*ok\(|$)")


def _waived(*comments: str) -> Set[str]:
    """Names waived by ``capture: ok(a, b) — reason`` comments (a waiver
    without a reason is none)."""
    names: Set[str] = set()
    for c in comments:
        for m in _WAIVER_RE.finditer(c or ""):
            if (m.group(2) or "").strip():
                names.update(t.strip() for t in m.group(1).split(",")
                             if t.strip())
    return names


def _new_scope(node: ast.AST) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef))


class _Scopes:
    """Binding lookups and kinds over one file."""

    def __init__(self, sf: SourceFile, config_fields: Set[str]):
        self.sf = sf
        self.config_fields = config_fields
        self.imports: Set[str] = set()
        for stmt in sf.tree.body:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                for a in stmt.names:
                    self.imports.add(a.asname or a.name.split(".")[0])

    # -- bindings -----------------------------------------------------------

    def bindings(self, fn: ast.AST, name: str) -> List[ast.AST]:
        """Binding sites of ``name`` local to ``fn`` (not descending into
        nested scopes): parameters, assigned values (the element of a
        literal tuple unpacked), or the binding statement."""
        out: List[ast.AST] = []
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                if a.arg == name:
                    out.append(a)

        def visit(node: ast.AST):
            for child in ast.iter_child_nodes(node):
                if _new_scope(child):
                    if not isinstance(child, ast.Lambda) and \
                            child.name == name:
                        out.append(child)
                    continue
                if isinstance(child, ast.Assign):
                    for t in child.targets:
                        _match(t, name, child.value, out)
                elif isinstance(child, ast.AnnAssign) and child.value:
                    _match(child.target, name, child.value, out)
                elif isinstance(child, (ast.AugAssign, ast.For,
                                        ast.AsyncFor)):
                    _match(child.target, name, child, out)
                elif isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        if item.optional_vars is not None:
                            _match(item.optional_vars, name, child, out)
                elif isinstance(child, ast.NamedExpr):
                    _match(child.target, name, child.value, out)
                elif isinstance(child, (ast.Import, ast.ImportFrom)):
                    for a in child.names:
                        if (a.asname or a.name.split(".")[0]) == name:
                            out.append(child)
                visit(child)

        body = getattr(fn, "body", None)
        if isinstance(body, list):
            visit(ast.Module(body=body, type_ignores=[]))
        return out

    def binding_before(self, scopes: Sequence[ast.AST], name: str,
                       line: int) -> Tuple[Optional[ast.AST], list]:
        """(the scope binding ``name``, its binding sites that count at
        ``line``: the last one before it, else all), innermost scope
        first; (None, []) for a global or builtin."""
        for fn in scopes:
            sites = self.bindings(fn, name)
            if sites:
                before = [s for s in sites
                          if getattr(s, "lineno", 0) <= line]
                return fn, ([max(before, key=lambda s: s.lineno)]
                            if before else sites)
        return None, []

    def local_defs(self, at: ast.AST, name: str) -> List[ast.AST]:
        """``name`` resolved to local functions in the scopes around
        ``at``: defs, or lambdas assigned to it."""
        scopes = self.sf.enclosing_functions(at)
        fn, sites = self.binding_before(scopes, name, at.lineno)
        if fn is None:
            return [n for n in self.sf.tree.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and n.name == name]
        return [s for s in sites
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))]

    # -- kinds --------------------------------------------------------------

    def _returns_state(self, fn: ast.AST) -> bool:
        rets = [r.value for r in ast.walk(fn) if isinstance(r, ast.Return)
                and r.value is not None
                and self.sf.enclosing_functions(r)[0] is fn]
        return bool(rets) and all(
            isinstance(v, ast.Call) and _provider(v) for v in rets)

    def kind(self, e: ast.AST, scopes: Sequence[ast.AST], line: int,
             depth: int = 0) -> Tuple[bool, str]:
        """(allowed, why not) for the value of ``e``."""
        if depth > 12:
            return False, "an expression too deep to classify"
        if isinstance(e, (ast.Constant, ast.JoinedStr)):
            return True, ""
        if isinstance(e, ast.Name):
            fn, sites = self.binding_before(scopes, e.id, line)
            if fn is None:
                return True, ""         # a module global or builtin
            return self.sites_kind(e.id, sites,
                                   scopes[list(scopes).index(fn):], line,
                                   depth + 1)
        if isinstance(e, ast.Attribute):
            if e.attr in STATIC_ATTRS or e.attr in self.config_fields:
                return True, ""
            base = e.value
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and base.id in self.imports and \
                    self.binding_before(scopes, base.id, line)[0] is None:
                return True, ""         # a module's constant
            return False, (f"an attribute read ({ast.unparse(e)}) — can "
                           "bind per-call tensors or per-instance state")
        if isinstance(e, ast.Call):
            fname = call_name(e)
            if _provider(e):
                return True, ""         # a state's persistent tensor
            if fname in STATIC_CALL_NAMES:
                return True, ""
            if isinstance(e.func, ast.Attribute) and \
                    e.func.attr in STATIC_METHOD_NAMES:
                return True, ""
            if isinstance(e.func, ast.Name):
                defs = self.local_defs(e, e.func.id)
                if defs and all(self._returns_state(d) for d in defs):
                    return True, ""
            return False, (f"the result of a call ({fname or '?'}(...)) "
                           "— a new tensor or object each call")
        if isinstance(e, (ast.UnaryOp, ast.BinOp, ast.Compare)) and \
                self.tensorish(e, scopes, line):
            return False, (f"arithmetic on a tensor ({ast.unparse(e)[:40]})"
                           " — a new tensor each call")
        if isinstance(e, ast.UnaryOp):
            return self.kind(e.operand, scopes, line, depth + 1)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return True, ""
            return self._all([e.left] + list(e.comparators), scopes, line,
                             depth)
        if isinstance(e, ast.BoolOp):
            return self._all(e.values, scopes, line, depth)
        if isinstance(e, ast.BinOp):
            return self._all([e.left, e.right], scopes, line, depth)
        if isinstance(e, ast.IfExp):
            return self._all([e.body, e.orelse], scopes, line, depth)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return self._all(e.elts, scopes, line, depth)
        if isinstance(e, ast.Dict):
            return self._all([k for k in e.keys if k is not None]
                             + e.values, scopes, line, depth)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.kind(e.elt, scopes, line, depth + 1)
        if isinstance(e, ast.DictComp):
            return self.kind(e.value, scopes, line, depth + 1)
        if isinstance(e, (ast.Subscript, ast.Starred)):
            return self.kind(e.value, scopes, line, depth + 1)
        return False, (f"a {type(e).__name__} expression — not provably "
                       "static")

    def _all(self, exprs, scopes, line, depth) -> Tuple[bool, str]:
        for sub in exprs:
            ok, why = self.kind(sub, scopes, line, depth + 1)
            if not ok:
                return ok, why
        return True, ""

    def sites_kind(self, name: str, sites: list, scopes: Sequence[ast.AST],
                   line: int, depth: int = 0) -> Tuple[bool, str]:
        for site in sites:
            if isinstance(site, ast.arg):
                return False, ("a parameter of an enclosing function: a "
                               "per-call value the graph freezes — make "
                               "it part of the graph's key")
            if isinstance(site, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(site, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue        # a nested function: audited on its own
            if isinstance(site, (ast.For, ast.AsyncFor, ast.With,
                                 ast.AsyncWith, ast.AugAssign)):
                return False, ("bound by a loop, a with or an augmented "
                               "assignment")
            ok, why = self.kind(site, scopes, line, depth)
            if not ok:
                return ok, why
        return True, ""

    def tensorish(self, e: ast.AST, scopes: Sequence[ast.AST], line: int,
                  depth: int = 0) -> bool:
        """Whether ``e`` is provably a tensor: a ``torch.*`` or tensor
        method's result, a state's tensor, or a name bound to one."""
        if depth > 8:
            return False
        if isinstance(e, ast.Call):
            d = call_name(e)
            if d.startswith("torch.") and not d.startswith("torch.cuda"):
                return True
            if _provider(e):
                return True
            return isinstance(e.func, ast.Attribute) and \
                e.func.attr in TENSOR_METHODS
        if isinstance(e, ast.Name):
            fn, sites = self.binding_before(scopes, e.id, line)
            return any(isinstance(s, ast.expr)
                       and self.tensorish(s, scopes, line, depth + 1)
                       for s in sites)
        if isinstance(e, ast.Subscript):
            return self.tensorish(e.value, scopes, line, depth + 1)
        if isinstance(e, ast.UnaryOp):
            return self.tensorish(e.operand, scopes, line, depth + 1)
        if isinstance(e, (ast.BinOp,)):
            return any(self.tensorish(x, scopes, line, depth + 1)
                       for x in (e.left, e.right))
        if isinstance(e, ast.BoolOp):
            return any(self.tensorish(x, scopes, line, depth + 1)
                       for x in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False
            return any(self.tensorish(x, scopes, line, depth + 1)
                       for x in [e.left] + list(e.comparators))
        return False


def _match(target: ast.AST, name: str, value: ast.AST, out: list) -> None:
    if isinstance(target, ast.Name) and target.id == name:
        out.append(value)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for i, elt in enumerate(target.elts):
            if isinstance(elt, ast.Name) and elt.id == name:
                if isinstance(value, (ast.Tuple, ast.List)) \
                        and len(value.elts) == len(target.elts):
                    out.append(value.elts[i])
                else:
                    out.append(value)
            elif isinstance(elt, (ast.Tuple, ast.List)):
                _match(elt, name, value, out)


def _provider(call: ast.Call) -> bool:
    return call_name(call).rsplit(".", 1)[-1] in STATE_PROVIDERS


def _arg(call: ast.Call, idx: int, *names: str) -> Optional[ast.AST]:
    if len(call.args) > idx:
        return call.args[idx]
    for kw in call.keywords:
        if kw.arg in names:
            return kw.value
    return None


def _names(e: Optional[ast.AST]) -> Set[str]:
    return {n.id for n in ast.walk(e) if isinstance(n, ast.Name)} \
        if e is not None else set()


class _Checker:
    def __init__(self, sf: SourceFile, config_fields: Set[str]):
        self.sf = sf
        self.sc = _Scopes(sf, config_fields)
        self.out: List[Finding] = []
        self.seen: Set[Tuple[int, int]] = set()

    def key_names(self, call: ast.Call, entry: str) -> Set[str]:
        """The names of the key the graph is stored under."""
        if entry == "run_wave":
            return _names(_arg(call, 0, "k"))
        parent = self.sf.parent(call)
        if not (isinstance(parent, ast.Assign) and parent.value is call):
            return set()
        keys: Set[str] = set()
        scopes = self.sf.enclosing_functions(call)
        for t in parent.targets:
            if isinstance(t, ast.Subscript):
                for name in _names(t.slice):
                    keys.add(name)
                    _, sites = self.sc.binding_before(scopes, name,
                                                      call.lineno)
                    for s in sites:
                        if isinstance(s, ast.expr):
                            keys |= _names(s)
        return keys

    def site(self, call: ast.Call, entry: str) -> None:
        sf = self.sf
        target = _arg(call, CAPTURE_CALLS[entry], "fn")
        if target is None:
            return
        if isinstance(target, ast.Name):
            encl = sf.enclosing_functions(call)
            if encl and getattr(encl[0], "name", "") in CAPTURE_CALLS and \
                    any(a.arg == target.id for a in encl[0].args.args):
                return      # forwarded: audited at the entry's call sites
            fns = self.sc.local_defs(call, target.id)
        elif isinstance(target, ast.Lambda):
            fns = [target]
        else:
            fns = []
        stmt_comment = sf.comment_near(call)
        if not fns:
            if "*" in _waived(stmt_comment):
                return
            expr = ast.unparse(target)[:48]
            self.out.append(Finding(
                CHECKER, "unresolvable", sf.rel, call.lineno,
                f"{entry} of {expr!r}, which is not a local function or "
                "lambda — what the graph freezes cannot be audited",
                f"{sf.qualname(call)}:{expr}"))
            return
        keys = self.key_names(call, entry)
        for fn in fns:
            self.audit(fn, call, keys, _waived(stmt_comment,
                                               self._stmt_comment(call)))

    def _stmt_comment(self, node: ast.AST) -> str:
        for a in [node] + list(self.sf.ancestors(node)):
            if isinstance(a, ast.stmt):
                return self.sf.comment_near(a)
        return ""

    def audit(self, fn: ast.AST, site: ast.Call, keys: Set[str],
              waived: Set[str]) -> None:
        sf = self.sf
        if (id(fn), id(site)) in self.seen:
            return
        self.seen.add((id(fn), id(site)))
        waived = waived | _waived(sf.comment_near(fn),
                                  self._stmt_comment(fn))
        qual = sf.qualname(fn) if not isinstance(fn, ast.Lambda) else \
            f"{sf.qualname(self._stmt_of(fn))}.<lambda>"
        scopes = sf.enclosing_functions(fn)
        line = site.lineno
        for name in sf.free_names(fn):
            if name in keys or name in waived:
                continue
            owner, sites = self.sc.binding_before(scopes, name, line)
            nested = [s for s in sites
                      if isinstance(s, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))]
            for inner in nested:
                self.audit(inner, site, keys, waived)
            ok, why = self.sc.sites_kind(
                name, sites, scopes[list(scopes).index(owner):]
                if owner is not None else scopes, line)
            if ok:
                continue
            self.out.append(Finding(
                CHECKER, "nonstatic-capture", sf.rel,
                getattr(fn, "lineno", line),
                f"{qual} is captured into a CUDA graph but closes over "
                f"{name!r}: {why}; a replay reads the value it had at the "
                f"capture (waive with '# capture: ok({name}) — reason')",
                f"{qual}:{name}"))
        if "sync" not in waived:
            self.syncs(fn, qual, set())

    def _stmt_of(self, node: ast.AST) -> ast.AST:
        for a in self.sf.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                return a
        return self.sf.tree

    def syncs(self, fn: ast.AST, qual: str, seen: Set[int]) -> None:
        """Host syncs in ``fn``'s body and the same class's methods it
        calls through ``self``."""
        if id(fn) in seen:
            return
        seen.add(id(fn))
        sf = self.sf
        scopes = [fn] + sf.enclosing_functions(fn)
        cls = sf.enclosing_class(fn)
        methods: Dict[str, ast.AST] = {}
        if cls is not None:
            methods = {m.name: m for m in cls.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        todo = list(body)
        while todo:
            node = todo.pop()
            if _new_scope(node):
                continue
            todo.extend(ast.iter_child_nodes(node))
            what = self._sync(node, scopes)
            if what and "sync" not in _waived(self._stmt_comment(node)):
                self.out.append(Finding(
                    CHECKER, "host-sync", sf.rel, node.lineno,
                    f"{what} in {qual}, which a CUDA graph captures: the "
                    "card waits for the host (a capture refuses it, a "
                    "replay skips the host's side)",
                    f"{qual}:{what.split(' ', 1)[0]}"))
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d.startswith("self.") and d.count(".") == 1 and \
                        d[5:] in methods:
                    self.syncs(methods[d[5:]], qual, seen)

    def _sync(self, node: ast.AST, scopes) -> str:
        line = getattr(node, "lineno", 0)
        if isinstance(node, ast.Call):
            f = node.func
            d = call_name(node)
            if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                return f".{f.attr}()"
            if (isinstance(f, ast.Attribute) and f.attr == "nonzero"
                    or d == "torch.nonzero") and not any(
                        kw.arg == "size" for kw in node.keywords):
                return "nonzero() without size="
            if d == "torch.where" and len(node.args) == 1:
                return "torch.where(cond) (a nonzero)"
            if d in ("bool", "int", "float") and node.args and \
                    self.sc.tensorish(node.args[0], scopes, line):
                return f"{d}() of a tensor"
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)) \
                and self.sc.tensorish(node.test, scopes, line):
            return "a branch on a tensor"
        return ""


def check(sources: List[SourceFile],
          config_fields: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        c = _Checker(sf, config_fields)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                entry = call_name(node).rsplit(".", 1)[-1]
                if entry in CAPTURE_CALLS:
                    c.site(node, entry)
        out += c.out
    return out
