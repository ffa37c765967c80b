"""Concurrency rules: static lock discipline and thread lifecycle.

**lock-discipline** — the Eraser lockset discipline (Savage et al.,
TOCS 1997) checked statically, scoped the way Engler et al. (SOSP 2001)
infer invariants from the codebase itself: a class that owns a lock or
starts a thread has DECLARED itself thread-shared, so every mutation of
its instance state outside ``__init__`` must honor a consistent lockset.
Per such class the rule classifies every mutation site of every
``self.<attr>``:

- **locked** — lexically under ``with self.<lock>`` (any attribute the
  class assigned from ``threading.Lock/RLock/Condition`` or the
  sanitizer's ``make_lock``/``make_rlock``/``make_condition``), or
  inside a PRIVATE method whose every intra-class call site is locked
  (the lock-held-by-caller helper pattern, e.g. ``ModelSLO._evaluate``);
- **worker-only** — reachable only from the class's thread-target
  scopes (single mutator thread: per-worker state like the batcher's
  ``_last_all_failed`` needs no lock);
- otherwise **unlocked-shared**.

A finding fires when an attribute's sites are inconsistent: a
read-modify-write (``+=``) or container mutation (``append``/``pop``/
``update``/subscript store/...) runs unlocked outside worker-only
scopes, or a plain rebind runs unlocked while OTHER sites of the same
attribute lock — the hole Eraser calls a lockset violation.  Module
globals get the same treatment in modules that own a module-level lock.
Deliberate exceptions sit on ``registries.SHARED_UNLOCKED`` with a
written reason (stale entries fail).

**thread-lifecycle** — every started ``threading.Thread`` must carry
``daemon=True`` or be joined somewhere in its module (a registered
shutdown path), or sit on ``registries.UNMANAGED_THREADS`` with a
reason: the static counterpart of the runtime no-leak hammers.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .engine import Corpus, Finding, rule
from . import registries
from .registries import ExclusionRegistry

#: attribute calls that mutate a container in place
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "move_to_end", "rotate", "sort", "reverse",
}

#: call spellings that construct a lock (threading primitives + the
#: runtime sanitizer's factories)
LOCK_CONSTRUCTORS = {"Lock", "RLock", "Condition", "make_lock",
                     "make_rlock", "make_condition"}

#: mutable-container constructors that mark a module global as shared
#: mutable state
CONTAINER_CONSTRUCTORS = {"dict", "list", "set", "OrderedDict", "deque",
                          "defaultdict", "Counter"}


def _is_lock_ctor(call: ast.Call) -> bool:
    fn = call.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    return name in LOCK_CONSTRUCTORS


def _self_attr(expr) -> Optional[str]:
    """``self.X`` -> ``X`` (peeling subscripts: ``self.X[k][j]`` -> X)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _base_name(expr) -> Optional[str]:
    """``NAME[k][j]`` -> NAME (module-global mutation detection)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id
    return None


class _Scope:
    """One function scope (method or nested def) inside a class or
    module."""

    __slots__ = ("name", "qual", "parent", "calls", "is_method",
                 "mutations", "thread_targets", "makes_thread",
                 "_call_locks")

    def __init__(self, name: str, qual: str, parent: Optional["_Scope"],
                 is_method: bool):
        self.name = name
        self.qual = qual              # e.g. "method.worker"
        self.parent = parent
        self.is_method = is_method    # direct child of the class body
        self.calls: Set[str] = set()  # names of self.X() / local f() calls
        # call name -> [bool: ran under a held lock] (second pass)
        self._call_locks: Dict[str, List[bool]] = {}
        # attr -> [(line, kind, locked_lockset)] ; kind: rmw|mutate|assign
        self.mutations: Dict[str, List[Tuple[int, str, frozenset]]] = {}
        self.thread_targets: Set[str] = set()   # scope/method names
        self.makes_thread = False


class _ClassScan(ast.NodeVisitor):
    """One class: lock attrs, thread targets, per-scope mutation sites
    with the lexically-held lockset."""

    def __init__(self, cls_node: ast.ClassDef):
        self.cls = cls_node
        self.lock_attrs: Set[str] = set()
        self.scopes: Dict[str, _Scope] = {}
        self._scope: Optional[_Scope] = None
        self._held: List[str] = []
        # pass 1: collect lock attrs (self.X = Lock() in any method,
        # X = Lock() in the class body) so pass 2 can classify `with`s
        for node in ast.walk(cls_node):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call) and _is_lock_ctor(node.value):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        self.lock_attrs.add(attr)
                    elif isinstance(t, ast.Name):
                        self.lock_attrs.add(t.id)   # class-body lock
        for stmt in cls_node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._visit_function(stmt, parent=None, is_method=True)

    # -- scope walking -----------------------------------------------------
    def _visit_function(self, node, parent: Optional[_Scope],
                        is_method: bool):
        qual = node.name if parent is None else f"{parent.qual}.{node.name}"
        scope = _Scope(node.name, qual, parent, is_method)
        self.scopes[scope.qual] = scope
        prev_scope, prev_held = self._scope, self._held
        self._scope, self._held = scope, []   # a nested def's body does
        #                                       NOT run under the
        #                                       enclosing `with`
        for stmt in node.body:
            self._visit(stmt)
        self._scope, self._held = prev_scope, prev_held

    def _visit(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_function(node, parent=self._scope, is_method=False)
            return
        if isinstance(node, ast.With):
            held = []
            for item in node.items:
                lock = self._lock_name(item.context_expr)
                if lock is not None:
                    held.append(lock)
            self._held.extend(held)
            for stmt in node.body:
                self._visit(stmt)
            for _ in held:
                self._held.pop()
            return
        self._inspect(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _lock_name(self, expr) -> Optional[str]:
        """``with self._lock`` / ``with Cls._lock`` -> the lock attr
        name when it is one of the class's known lock attrs."""
        if isinstance(expr, ast.Attribute) and expr.attr in self.lock_attrs:
            return expr.attr
        if isinstance(expr, ast.Name) and expr.id in self.lock_attrs:
            return expr.id
        return None

    # -- site collection ---------------------------------------------------
    def _record(self, attr: str, line: int, kind: str):
        if attr in self.lock_attrs:
            return
        self._scope.mutations.setdefault(attr, []).append(
            (line, kind, frozenset(self._held)))

    def _inspect(self, node):
        s = self._scope
        if s is None:
            return
        if isinstance(node, ast.AugAssign):
            attr = _self_attr(node.target)
            if attr is not None:
                kind = ("rmw" if not isinstance(node.target, ast.Subscript)
                        else "mutate")
                self._record(attr, node.lineno, kind)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t)
                    if attr is not None:
                        self._record(attr, node.lineno, "mutate")
                else:
                    attr = _self_attr(t)
                    if attr is not None:
                        self._record(attr, node.lineno, "assign")
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    self._record(attr, node.lineno, "mutate")
        elif isinstance(node, ast.Call):
            fn = node.func
            # self.X.append(...) and friends
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in MUTATOR_METHODS):
                attr = _self_attr(fn.value)
                if attr is not None:
                    self._record(attr, node.lineno, "mutate")
            # intra-class call graph: self.m(...) / local f(...)
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "self"):
                s.calls.add(fn.attr)
            elif isinstance(fn, ast.Name):
                s.calls.add(fn.id)
            # thread creation + target resolution
            if (isinstance(fn, ast.Attribute) and fn.attr == "Thread") or (
                    isinstance(fn, ast.Name) and fn.id == "Thread"):
                s.makes_thread = True
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    tgt = kw.value
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        s.thread_targets.add(tgt.attr)
                    elif isinstance(tgt, ast.Name):
                        s.thread_targets.add(f"{s.qual}.{tgt.id}")
                        s.thread_targets.add(tgt.id)


def _resolve_scopes(scan: _ClassScan):
    """(thread_roots, worker_only, locked_scopes): the reachability and
    helper-credit classification over the intra-class call graph."""
    scopes = scan.scopes

    def resolve_call(caller: _Scope, name: str) -> Optional[str]:
        # a local nested def shadows a method of the same name
        nested = f"{caller.qual}.{name}"
        if nested in scopes:
            return nested
        if name in scopes and scopes[name].is_method:
            return name
        return None

    edges: Dict[str, Set[str]] = {q: set() for q in scopes}
    for q, s in scopes.items():
        for name in s.calls:
            callee = resolve_call(s, name)
            if callee is not None:
                edges[q].add(callee)

    # thread roots: scopes named as Thread targets anywhere in the class
    roots: Set[str] = set()
    for s in scopes.values():
        for tname in s.thread_targets:
            if tname in scopes:
                roots.add(tname)

    def reach(starts: Set[str]) -> Set[str]:
        seen = set(starts)
        frontier = list(starts)
        while frontier:
            q = frontier.pop()
            for nxt in edges.get(q, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    from_roots = reach(roots)
    # public surface: every method not starting with "_" plus __init__
    # (external callers), and every nested def they reach
    public = {q for q, s in scopes.items()
              if s.is_method and (not s.name.startswith("_")
                                  or s.name == "__init__")}
    from_public = reach(public)
    worker_only = from_roots - from_public

    # helper credit: a PRIVATE method whose every intra-class call site
    # is locked counts as locked itself (lock held by caller); iterate
    # to fixpoint so credit flows through helper chains
    locked_scopes: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for q, s in scopes.items():
            if q in locked_scopes:
                continue
            if not (s.name.startswith("_") and s.name != "__init__"):
                continue
            callers = [(cq, cs) for cq, cs in scopes.items()
                       if q in edges.get(cq, ())]
            if not callers:
                continue
            if all(cs.qual in locked_scopes
                   or _all_calls_locked(scan, cs, s.name)
                   for _cq, cs in callers):
                locked_scopes.add(q)
                changed = True
    return roots, worker_only, locked_scopes


def _all_calls_locked(scan: _ClassScan, caller: _Scope,
                      callee_name: str) -> bool:
    """Every ``self.<callee_name>(...)`` / ``<callee_name>(...)`` call
    in ``caller`` runs under a held lock (per the caller's recorded
    call locksets)."""
    sites = getattr(caller, "_call_locks", {}).get(callee_name)
    return bool(sites) and all(sites)


class _CallLockScan(ast.NodeVisitor):
    """Second pass per scope: record whether each intra-class call runs
    under a held lock (feeds the helper credit)."""

    def __init__(self, scan: _ClassScan):
        self.scan = scan

    def run(self):
        for stmt in self.scan.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_function(stmt, None)

    def _walk_function(self, node, parent_qual):
        qual = node.name if parent_qual is None else \
            f"{parent_qual}.{node.name}"
        scope = self.scan.scopes.get(qual)
        if scope is None:
            return
        scope._call_locks = {}        # type: ignore[attr-defined]
        self._held = 0
        self._scope = scope
        self._qual = qual
        for stmt in node.body:
            self._walk(stmt, qual)

    def _walk(self, node, qual):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            saved_held, saved_scope = self._held, self._scope
            self._walk_function(node, qual)
            self._held, self._scope = saved_held, saved_scope
            return
        if isinstance(node, ast.With):
            locked = sum(
                1 for item in node.items
                if self.scan._lock_name(item.context_expr) is not None)
            self._held += locked
            for stmt in node.body:
                self._walk(stmt, qual)
            self._held -= locked
            return
        if isinstance(node, ast.Call):
            fn = node.func
            name = None
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "self"):
                name = fn.attr
            elif isinstance(fn, ast.Name):
                name = fn.id
            if name is not None:
                self._scope._call_locks.setdefault(name, []).append(
                    self._held > 0)
        for child in ast.iter_child_nodes(node):
            self._walk(child, qual)


def _class_findings(rel: str, cls_node: ast.ClassDef,
                    reg: ExclusionRegistry,
                    candidates: List[str]) -> List[Finding]:
    scan = _ClassScan(cls_node)
    owns_thread = any(s.makes_thread for s in scan.scopes.values())
    if not scan.lock_attrs and not owns_thread:
        return []            # not declared thread-shared: out of scope
    _CallLockScan(scan).run()
    roots, worker_only, locked_scopes = _resolve_scopes(scan)

    # collect per-attr sites (scope, line, kind, locked?)
    attr_sites: Dict[str, List[Tuple[str, int, str, bool]]] = {}
    for q, s in scan.scopes.items():
        if s.is_method and s.name == "__init__":
            continue         # single-threaded construction
        for attr, sites in s.mutations.items():
            for line, kind, held in sites:
                locked = bool(held) or q in locked_scopes
                attr_sites.setdefault(attr, []).append(
                    (q, line, kind, locked))

    out: List[Finding] = []
    for attr, sites in sorted(attr_sites.items()):
        key = f"{rel}:{cls_node.name}.{attr}"
        any_locked = any(locked for _q, _l, _k, locked in sites)
        unlocked = [(q, line, kind) for q, line, kind, locked in sites
                    if not locked]
        if not unlocked:
            continue
        all_worker_only = all(q in worker_only for q, _l, _k, locked
                              in sites if not locked)
        problem = None
        if any(kind in ("rmw", "mutate") for _q, _l, kind in unlocked):
            if not (all_worker_only and not any_locked):
                problem = ("read-modify-write/container mutation outside "
                           "the lock")
        if problem is None and any_locked:
            # plain rebinds are only a finding when the attr is locked
            # elsewhere (inconsistent lockset)
            if not all_worker_only:
                problem = ("attribute locked at some sites but rebound "
                           "unlocked at others (inconsistent lockset)")
        if problem is None:
            continue
        candidates.append(key)
        if reg.excuses(key):
            continue
        q, line, kind = unlocked[0]
        lines = sorted({l for _q, l, _k in unlocked})
        out.append(Finding(
            "lock-discipline", rel, line,
            f"{cls_node.name}.{attr}: {problem} "
            f"(unlocked sites: {lines}; scopes: "
            f"{sorted({uq for uq, _l, _k in unlocked})})",
            hint="hold the class lock at every mutation site, or add "
                 f"{key!r} to analysis.registries.SHARED_UNLOCKED with "
                 "a reason"))
    return out


# ---------------------------------------------------------------------------
# module-global discipline
# ---------------------------------------------------------------------------

class _ModuleScan(ast.NodeVisitor):
    """Module-level locks + container globals + per-function mutations
    of them."""

    def __init__(self, tree: ast.Module):
        self.locks: Set[str] = set()
        self.containers: Set[str] = set()
        self.sites: Dict[str, List[Tuple[str, int, str, bool]]] = {}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Call):
                fn = stmt.value.func
                name = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None)
                for t in stmt.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if name in LOCK_CONSTRUCTORS:
                        self.locks.add(t.id)
                    elif name in CONTAINER_CONSTRUCTORS:
                        self.containers.add(t.id)
            elif isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, (ast.Dict, ast.List, ast.Set)):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.containers.add(t.id)
        if not self.locks:
            return
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_function(stmt)

    def _walk_function(self, node):
        self._qual = node.name
        self._held = 0
        for stmt in node.body:
            self._walk(stmt)

    def _walk(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            saved_q, saved_h = self._qual, self._held
            self._walk_function(node)
            self._qual, self._held = saved_q, saved_h
            return
        if isinstance(node, ast.With):
            locked = sum(1 for item in node.items
                         if isinstance(item.context_expr, ast.Name)
                         and item.context_expr.id in self.locks)
            self._held += locked
            for stmt in node.body:
                self._walk(stmt)
            self._held -= locked
            return
        if isinstance(node, ast.AugAssign):
            name = _base_name(node.target)
            if name in self.containers:
                self.sites.setdefault(name, []).append(
                    (self._qual, node.lineno, "rmw", self._held > 0))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    name = _base_name(t)
                    if name in self.containers:
                        self.sites.setdefault(name, []).append(
                            (self._qual, node.lineno, "mutate",
                             self._held > 0))
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in MUTATOR_METHODS
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in self.containers):
                self.sites.setdefault(fn.value.id, []).append(
                    (self._qual, node.lineno, "mutate", self._held > 0))
        for child in ast.iter_child_nodes(node):
            self._walk(child)


def _module_findings(rel: str, tree: ast.Module, reg: ExclusionRegistry,
                     candidates: List[str]) -> List[Finding]:
    scan = _ModuleScan(tree)
    out: List[Finding] = []
    for name, sites in sorted(scan.sites.items()):
        unlocked = [(q, line, kind) for q, line, kind, locked in sites
                    if not locked]
        if not unlocked:
            continue
        key = f"{rel}:<module>.{name}"
        candidates.append(key)
        if reg.excuses(key):
            continue
        _q, line, _k = unlocked[0]
        out.append(Finding(
            "lock-discipline", rel, line,
            f"module global {name!r} mutated outside the module lock "
            f"(sites: {sorted({l for _sq, l, _sk in unlocked})})",
            hint="hold the module lock, or add "
                 f"{key!r} to analysis.registries.SHARED_UNLOCKED with "
                 "a reason"))
    return out


def lock_discipline_findings(corpus: Corpus,
                             exclusions=None) -> List[Finding]:
    reg = ExclusionRegistry(
        "lock-discipline", "SHARED_UNLOCKED",
        registries.SHARED_UNLOCKED if exclusions is None else exclusions)
    out: List[Finding] = []
    candidates: List[str] = []
    for rel, sf in corpus.items():
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                out.extend(_class_findings(rel, node, reg, candidates))
        out.extend(_module_findings(rel, sf.tree, reg, candidates))
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("lock-discipline",
      "thread-shared mutable state (classes owning locks/threads, "
      "locked modules) is mutated under a consistent lockset or sits on "
      "SHARED_UNLOCKED with a reason")
def _lock_discipline(corpus: Corpus) -> List[Finding]:
    return lock_discipline_findings(corpus)


# ---------------------------------------------------------------------------
# thread-lifecycle
# ---------------------------------------------------------------------------

class _ThreadScan(ast.NodeVisitor):
    """Every ``threading.Thread(...)`` creation: daemon kwarg, the
    target it was assigned to (for the join check), and its scope."""

    def __init__(self):
        self.sites: List[dict] = []
        self._stack: List[str] = []

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call) and self._is_thread(
                node.value):
            names = []
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.append(t.id)
                attr = _self_attr(t)
                if attr is not None:
                    names.append(attr)
            self._record(node.value, names)
        self.generic_visit(node)

    def visit_Call(self, node):
        if self._is_thread(node):
            # bare Thread(...) calls not captured by an Assign above
            if not any(s["node"] is node for s in self.sites):
                self._record(node, [])
        self.generic_visit(node)

    @staticmethod
    def _is_thread(call: ast.Call) -> bool:
        fn = call.func
        return ((isinstance(fn, ast.Attribute) and fn.attr == "Thread")
                or (isinstance(fn, ast.Name) and fn.id == "Thread"))

    def _record(self, call: ast.Call, names: List[str]):
        daemon = None
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        self.sites.append({
            "node": call, "line": call.lineno, "daemon": daemon,
            "names": names,
            "qual": ".".join(self._stack) if self._stack else "<module>"})


def thread_lifecycle_findings(corpus: Corpus,
                              exclusions=None) -> List[Finding]:
    reg = ExclusionRegistry(
        "thread-lifecycle", "UNMANAGED_THREADS",
        registries.UNMANAGED_THREADS if exclusions is None
        else exclusions)
    out: List[Finding] = []
    candidates: List[str] = []
    for rel, sf in corpus.items():
        scan = _ThreadScan()
        scan.visit(sf.tree)
        for site in scan.sites:
            if site["daemon"] is True:
                continue
            # anchored matches: `out.join(` must not satisfy a thread
            # variable named `t`
            joined = any(
                re.search(rf"\b(?:self\.)?{re.escape(name)}\.join\(",
                          sf.text)
                for name in site["names"])
            # `.daemon = True` set post-construction on a named target
            daemonized = any(
                re.search(rf"\b(?:self\.)?{re.escape(name)}"
                          rf"\.daemon\s*=\s*True", sf.text)
                for name in site["names"])
            if joined or daemonized:
                continue
            key = f"{rel}:{site['qual']}"
            candidates.append(key)
            if reg.excuses(key):
                continue
            out.append(Finding(
                "thread-lifecycle", rel, site["line"],
                f"thread started in {site['qual']} has no daemon flag "
                f"and no join/shutdown path in its module",
                hint="pass daemon=True or join the thread on shutdown, "
                     f"or add {key!r} to "
                     "analysis.registries.UNMANAGED_THREADS with a "
                     "reason"))
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("thread-lifecycle",
      "every started threading.Thread has a daemon flag or a registered "
      "join/shutdown path (or sits on UNMANAGED_THREADS with a reason)")
def _thread_lifecycle(corpus: Corpus) -> List[Finding]:
    return thread_lifecycle_findings(corpus)
