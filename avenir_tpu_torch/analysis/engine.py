"""The analysis engine: shared-parse corpus, rule registry, findings.

The port's copy of ``avenir_tpu/analysis/engine.py``.  The package is
parsed ONCE into a :class:`Corpus` and every registered rule checks the
shared trees.  Rules return structured :class:`Finding` s so one CLI
(``python -m avenir_tpu_torch analyze``) and one test can run the whole
catalog with text or JSON output.  The default corpus is this package,
``avenir_tpu_torch``, with the repo's README as the documentation
surface.
"""

from __future__ import annotations

import ast
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence


class SourceFile:
    """One parsed package module (parse happens once, in Corpus)."""

    __slots__ = ("rel", "path", "text", "tree")

    def __init__(self, rel: str, path: str, text: str, tree: ast.AST):
        self.rel = rel          # package-relative, e.g. "core/io.py"
        self.path = path
        self.text = text
        self.tree = tree


class Corpus:
    """Every ``.py`` under one root, parsed once and shared by all
    rules.  ``readme`` is the documentation surface the config-key rule
    checks (None = no README check).  ``parse_cache`` optionally maps a
    per-file cache key (see :mod:`.cache`) to an already-parsed tree so
    a warm run skips re-parsing unchanged files."""

    def __init__(self, root: str, readme_path: Optional[str] = None,
                 parse_cache: Optional[dict] = None):
        self.root = root
        self.readme_path = readme_path
        self.files: Dict[str, SourceFile] = {}
        self._readme: Optional[str] = None
        self._dataflow: Optional["Dataflow"] = None
        self.parsed_files = 0      # files actually ast.parse'd this load
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path) as fh:
                    text = fh.read()
                tree = None
                if parse_cache is not None:
                    cached = parse_cache.get(rel)
                    if cached is not None and cached[0] == text:
                        tree = cached[1]
                if tree is None:
                    tree = ast.parse(text, filename=path)
                    self.parsed_files += 1
                self.files[rel] = SourceFile(rel, path, text, tree)

    def dataflow(self) -> "Dataflow":
        """The corpus's interprocedural dataflow index, built once and
        shared by every rule that needs reachability (fold-purity,
        carry-portability)."""
        if self._dataflow is None:
            self._dataflow = Dataflow(self)
        return self._dataflow

    @property
    def readme(self) -> str:
        if self._readme is None:
            if self.readme_path and os.path.exists(self.readme_path):
                with open(self.readme_path) as fh:
                    self._readme = fh.read()
            else:
                self._readme = ""
        return self._readme

    def get(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel)

    def items(self):
        return sorted(self.files.items())


class Finding:
    """One structured rule violation.

    ``tag`` subdivides a rule's findings: ``violation`` (the rule's own
    check), ``stale-exclusion`` (a registry entry whose site no longer
    exists or no longer violates), ``empty-reason`` (a registry entry
    without a written reason).  All three fail ``--strict``."""

    __slots__ = ("rule", "file", "line", "message", "hint", "tag")

    def __init__(self, rule: str, file: str, line: int, message: str,
                 hint: str = "", tag: str = "violation"):
        self.rule = rule
        self.file = file
        self.line = int(line)
        self.message = message
        self.hint = hint
        self.tag = tag

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        s = f"{self.rule}  {loc}  {self.message}"
        if self.hint:
            s += f"  [fix: {self.hint}]"
        return s

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "hint": self.hint,
                "tag": self.tag}

    def __repr__(self):
        return f"Finding({self.format()!r})"


class Rule:
    """One registered check: ``fn(corpus) -> [Finding]``.

    ``scope`` is ``"source"`` for pure-AST rules (they run on any
    corpus, including test fixtures) or ``"project"`` for rules that
    import the real package (driver registry introspection) and only
    make sense against this package, ``avenir_tpu_torch``."""

    __slots__ = ("id", "doc", "fn", "scope")

    def __init__(self, rule_id: str, doc: str,
                 fn: Callable[[Corpus], List[Finding]],
                 scope: str = "source"):
        if scope not in ("source", "project"):
            raise ValueError(f"bad rule scope: {scope!r}")
        self.id = rule_id
        self.doc = doc
        self.fn = fn
        self.scope = scope

    def check(self, corpus: Corpus) -> List[Finding]:
        return self.fn(corpus)


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, doc: str, scope: str = "source"):
    """Decorator registering ``fn(corpus) -> [Finding]`` under a stable
    rule id (the id findings, exclusions, and ``--rules`` name)."""
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id: {rule_id}")
        RULES[rule_id] = Rule(rule_id, doc, fn, scope)
        return fn
    return deco


def all_rule_ids() -> List[str]:
    return sorted(RULES)


_PACKAGE_CORPUS: Optional[Corpus] = None

#: the package name an absolute import of the analyzed package starts
#: with (``from avenir_tpu_torch.core import io``)
PACKAGE_NAME = "avenir_tpu_torch"


def package_root() -> str:
    """The directory of the analyzed package (``avenir_tpu_torch/``),
    found from this file, so nothing is imported to locate it."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_package_corpus(fresh: bool = False) -> Corpus:
    """The corpus every default run analyzes: this package,
    ``avenir_tpu_torch``, with the repo README as the doc surface.
    Cached per process (one parse feeds the CLI and every test);
    ``fresh=True`` re-parses."""
    global _PACKAGE_CORPUS
    if _PACKAGE_CORPUS is None or fresh:
        pkg = package_root()
        _PACKAGE_CORPUS = Corpus(pkg, readme_path=os.path.join(
            os.path.dirname(pkg), "README.md"))
    return _PACKAGE_CORPUS


def run_rules(corpus: Corpus,
              rule_ids: Optional[Sequence[str]] = None,
              scopes: Sequence[str] = ("source", "project")):
    """Run the selected rules over one shared corpus.

    Returns ``(findings, report)`` where ``report`` is the JSON-ready
    run summary (per-rule finding counts and durations)."""
    if rule_ids is None:
        selected = [RULES[r] for r in all_rule_ids()
                    if RULES[r].scope in scopes]
    else:
        unknown = sorted(set(rule_ids) - set(RULES))
        if unknown:
            raise KeyError(
                f"unknown rule id(s): {unknown}; known: {all_rule_ids()}")
        selected = [RULES[r] for r in rule_ids]
    findings: List[Finding] = []
    per_rule = []
    t0 = time.monotonic()
    for r in selected:
        rt0 = time.monotonic()
        got = r.check(corpus)
        findings.extend(got)
        per_rule.append({"rule": r.id, "findings": len(got),
                         "ms": round((time.monotonic() - rt0) * 1e3, 2)})
    # deterministic (file, line, rule) order: reports diff stably across
    # runs and machines, and a file's findings read top-to-bottom
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    report = {"root": corpus.root,
              "files": len(corpus.files),
              "rules": per_rule,
              "findings": [f.to_dict() for f in findings],
              "total_findings": len(findings),
              "duration_ms": round((time.monotonic() - t0) * 1e3, 2)}
    return findings, report


def write_json_report(path: str, report: dict) -> None:
    """Atomic JSON findings report (the CI artifact)."""
    from ..core.io import atomic_write_text
    atomic_write_text(path, json.dumps(report, indent=2) + "\n")


# ---------------------------------------------------------------------------
# shared AST helpers (used by several rule modules)
# ---------------------------------------------------------------------------

class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor tracking the enclosing class/function qualname stack
    (the ``Class.method`` / ``func.<locals>`` naming the legacy walkers
    used)."""

    def __init__(self):
        self.stack: List[str] = []

    def qual(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


# ---------------------------------------------------------------------------
# the light interprocedural dataflow pass
# ---------------------------------------------------------------------------

#: attribute-call names too generic to resolve by name (they would edge
#: into unrelated same-file classes: dict/list/str verbs, context hooks)
_ATTR_STOPLIST = frozenset({
    "get", "put", "set", "items", "keys", "values", "append", "add",
    "pop", "update", "extend", "remove", "clear", "join", "split",
    "strip", "format", "read", "write", "close", "open", "copy",
    "start", "stop", "run", "wait", "notify", "acquire", "release",
    "setdefault", "sort", "count", "index", "startswith", "endswith",
})

#: method names that mutate their receiver (a call ``G.append(...)`` on
#: a module global marks the global mutable)
_MUTATOR_METHODS = frozenset({
    "append", "add", "pop", "update", "extend", "remove", "clear",
    "setdefault", "insert", "popleft", "appendleft", "discard",
})


def dotted_name(node) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class FunctionInfo:
    """One function/method's def-use summary: the calls it makes, the
    ``self.*`` attributes and module globals it reads/writes, and its
    AST node (rules walk the body for their own site patterns)."""

    __slots__ = ("rel", "qual", "node", "calls", "self_reads",
                 "self_writes", "global_reads", "global_writes")

    def __init__(self, rel: str, qual: str, node):
        self.rel = rel
        self.qual = qual
        self.node = node
        #: (kind, base, name) with kind in {bare, self, mod, attr}
        self.calls: List[tuple] = []
        self.self_reads: set = set()
        self.self_writes: set = set()
        self.global_reads: set = set()
        self.global_writes: set = set()


class _ModuleIndex:
    """Per-module symbol tables feeding the call graph: functions by
    qualname, classes with their method names, module globals (and the
    mutable subset), and import resolution back into the corpus."""

    def __init__(self, corpus: "Corpus", rel: str, tree):
        self.rel = rel
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, set] = {}
        self.class_lines: Dict[str, int] = {}
        self.class_bases: Dict[str, List[str]] = {}
        self.module_globals: set = set()
        self.mutated_globals: set = set()
        self.mutable_literal_globals: set = set()
        self.escaped_globals: set = set()
        self.mod_imports: Dict[str, str] = {}     # alias -> corpus rel
        self.from_imports: Dict[str, tuple] = {}  # name -> (rel, orig)
        self._collect_toplevel(tree)
        self._collect_imports(corpus, tree)
        self._collect_functions(tree)

    def effectively_mutable_globals(self) -> set:
        """Module globals whose reads are nondeterministic process
        state: mutated in-module (rebind/subscript/mutator call), or
        bound to a mutable container that escapes into a call (the
        pass-by-reference cache idiom) — a read-only constant dict
        stays pure."""
        return self.mutated_globals | (self.mutable_literal_globals
                                       & self.escaped_globals)

    # -- import resolution -------------------------------------------------
    def _resolve_rel(self, corpus, level: int, module: Optional[str],
                     name: Optional[str] = None):
        """Corpus rel path of a relative/absolute import target (the
        module itself, or ``module/name`` when ``name`` is a submodule);
        returns ``(rel_or_None, name_is_module)``."""
        parts = self.rel.split("/")[:-1]          # importing pkg path
        if level > 0:
            base = parts[:len(parts) - (level - 1)] if level > 1 else parts
        else:
            mod_parts = (module or "").split(".")
            # absolute import of this package: strip the package root
            if mod_parts and mod_parts[0] == PACKAGE_NAME:
                mod_parts = mod_parts[1:]
                base = []
                module = ".".join(mod_parts)
            else:
                return None, False
        target = base + ([p for p in module.split(".") if p]
                         if module else [])

        def file_of(p):
            for cand in ("/".join(p) + ".py",
                         "/".join(p) + "/__init__.py" if p else None):
                if cand and cand in corpus.files:
                    return cand
            return None

        if name is not None:
            sub = file_of(target + [name])
            if sub is not None:
                return sub, True
        return file_of(target), False

    def _collect_imports(self, corpus, tree) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            for alias in node.names:
                local = alias.asname or alias.name
                rel, is_mod = self._resolve_rel(
                    corpus, node.level, node.module, alias.name)
                if rel is None:
                    continue
                if is_mod:
                    self.mod_imports[local] = rel
                else:
                    self.from_imports[local] = (rel, alias.name)

    # -- symbol tables -----------------------------------------------------
    def _collect_toplevel(self, tree) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                methods = set()
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        methods.add(sub.name)
                self.classes[node.name] = methods
                self.class_lines[node.name] = node.lineno
                self.class_bases[node.name] = [
                    b for b in (dotted_name(base) for base in node.bases)
                    if b]
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = getattr(node, "value", None)
                mutable = isinstance(value, (ast.Dict, ast.List,
                                             ast.Set))
                if isinstance(value, ast.Call):
                    ctor = dotted_name(value.func) or ""
                    mutable = ctor.rsplit(".", 1)[-1] in (
                        "dict", "list", "set", "deque", "defaultdict",
                        "OrderedDict", "Counter")
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.module_globals.add(t.id)
                        if mutable:
                            self.mutable_literal_globals.add(t.id)

    def _collect_functions(self, tree) -> None:
        idx = self

        class Walk(ScopedVisitor):
            def __init__(self):
                super().__init__()
                self.fn_stack: List[FunctionInfo] = []

            def visit_ClassDef(self, node):
                # class BODIES execute at import time: statements like
                # `LANES = torch.cuda.device_count()` must be visible to
                # the reachability rules, so each class gets a synthetic
                # `<Cls>.<class>` scope (methods stay separate nodes —
                # defining one is not calling one)
                self.stack.append(node.name)
                info = FunctionInfo(idx.rel,
                                    f"{self.qual()}.<class>", node)
                idx.functions[info.qual] = info
                self.fn_stack.append(info)
                self.generic_visit(node)
                self.fn_stack.pop()
                self.stack.pop()

            def visit_FunctionDef(self, node):
                self.stack.append(node.name)
                info = FunctionInfo(idx.rel, self.qual(), node)
                idx.functions[info.qual] = info
                if (self.fn_stack
                        and not self.fn_stack[-1].qual.endswith(
                            ".<class>")):
                    # lexically nested defs run in the parent's context
                    # (callbacks, closures): an implicit call edge keeps
                    # them reachable whenever the parent is
                    self.fn_stack[-1].calls.append(
                        ("nested", None, info.qual))
                self.fn_stack.append(info)
                self.generic_visit(node)
                self.fn_stack.pop()
                self.stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def _info(self):
                return self.fn_stack[-1] if self.fn_stack else None

            def visit_Global(self, node):
                info = self._info()
                if info is not None:
                    info.global_writes.update(node.names)
                    idx.mutated_globals.update(node.names)
                self.generic_visit(node)

            def visit_Attribute(self, node):
                info = self._info()
                if (info is not None and isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                    if isinstance(node.ctx, ast.Load):
                        info.self_reads.add(node.attr)
                    else:
                        info.self_writes.add(node.attr)
                self.generic_visit(node)

            def visit_Name(self, node):
                info = self._info()
                if info is not None and node.id in idx.module_globals:
                    if isinstance(node.ctx, ast.Load):
                        info.global_reads.add(node.id)
                    else:
                        info.global_writes.add(node.id)
                        idx.mutated_globals.add(node.id)
                self.generic_visit(node)

            def visit_Subscript(self, node):
                # G[k] = v / del G[k] on a module global mutates it
                if (not isinstance(node.ctx, ast.Load)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in idx.module_globals):
                    idx.mutated_globals.add(node.value.id)
                self.generic_visit(node)

            def visit_Call(self, node):
                info = self._info()
                fn = node.func
                for arg in node.args:
                    # a module global handed to a call escapes: the
                    # callee may mutate the container (the pass-by-
                    # reference cache idiom)
                    if (isinstance(arg, ast.Name)
                            and arg.id in idx.module_globals):
                        idx.escaped_globals.add(arg.id)
                if info is not None:
                    if isinstance(fn, ast.Name):
                        info.calls.append(("bare", None, fn.id))
                    elif isinstance(fn, ast.Attribute):
                        base = fn.value
                        if isinstance(base, ast.Name):
                            if base.id == "self":
                                info.calls.append(("self", None, fn.attr))
                            else:
                                info.calls.append(("mod", base.id,
                                                   fn.attr))
                                # G.append(...) on a module global
                                if (base.id in idx.module_globals
                                        and fn.attr in _MUTATOR_METHODS):
                                    idx.mutated_globals.add(base.id)
                        else:
                            info.calls.append(("attr", None, fn.attr))
                self.generic_visit(node)

        Walk().visit(tree)


class Dataflow:
    """The corpus-wide call graph + def-use index: per-function
    summaries (:class:`FunctionInfo`) and one-level call resolution —
    bare names to same-module functions/classes and from-imported corpus
    functions, ``self.m`` to the enclosing class, ``alias.f`` through
    resolved module imports, and ``obj.m`` by unique method name within
    the module (a deliberate over-approximation; generic verbs on
    :data:`_ATTR_STOPLIST` never resolve).  :meth:`reachable` closes
    over those edges — the substrate for the distributed-readiness
    rules (fold-purity, carry-portability)."""

    def __init__(self, corpus: "Corpus"):
        self.corpus = corpus
        self.modules: Dict[str, _ModuleIndex] = {
            rel: _ModuleIndex(corpus, rel, sf.tree)
            for rel, sf in corpus.items()}
        self._callees: Dict[tuple, set] = {}

    def function(self, rel: str, qual: str) -> Optional[FunctionInfo]:
        idx = self.modules.get(rel)
        return idx.functions.get(qual) if idx else None

    def expand_prefixes(self, rel: str,
                        prefixes: Sequence[str]) -> List[tuple]:
        """Every (rel, qual) whose qualname equals a prefix or nests
        under it (``prefix.<inner>``)."""
        idx = self.modules.get(rel)
        if idx is None:
            return []
        out = []
        for qual in idx.functions:
            for p in prefixes:
                if qual == p or qual.startswith(p + "."):
                    out.append((rel, qual))
                    break
        return out

    def callees(self, key: tuple) -> set:
        if key in self._callees:
            return self._callees[key]
        rel, qual = key
        idx = self.modules.get(rel)
        info = idx.functions.get(qual) if idx else None
        out: set = set()
        if info is not None:
            cls = qual.split(".")[0] if "." in qual else None
            for kind, base, name in info.calls:
                if kind == "nested":
                    out.add((rel, name))
                elif kind == "self" and cls in idx.classes:
                    if name in idx.classes[cls]:
                        out.add((rel, f"{cls}.{name}"))
                elif kind == "bare":
                    if name in idx.functions:
                        out.add((rel, name))
                    elif (name in idx.classes
                          and "__init__" in idx.classes[name]):
                        out.add((rel, f"{name}.__init__"))
                    elif name in idx.from_imports:
                        trel, orig = idx.from_imports[name]
                        tidx = self.modules.get(trel)
                        if tidx and orig in tidx.functions:
                            out.add((trel, orig))
                        elif (tidx and orig in tidx.classes
                              and "__init__" in tidx.classes[orig]):
                            out.add((trel, f"{orig}.__init__"))
                elif kind == "mod":
                    if base in idx.mod_imports:
                        trel = idx.mod_imports[base]
                        tidx = self.modules.get(trel)
                        if tidx and name in tidx.functions:
                            out.add((trel, name))
                elif kind == "attr" and name not in _ATTR_STOPLIST:
                    owners = [c for c, ms in idx.classes.items()
                              if name in ms]
                    if len(owners) == 1:
                        out.add((rel, f"{owners[0]}.{name}"))
        self._callees[key] = out
        return out

    def reachable(self, roots: Sequence[tuple],
                  max_depth: Optional[int] = None) -> set:
        """BFS closure of (rel, qual) keys over resolved call edges
        (``max_depth`` bounds the hop count from the roots; None =
        transitive closure)."""
        seen = set()
        frontier = [r for r in roots
                    if self.function(*r) is not None]
        seen.update(frontier)
        depth = 0
        while frontier and (max_depth is None or depth < max_depth):
            nxt = []
            for key in frontier:
                for callee in self.callees(key):
                    if callee not in seen:
                        seen.add(callee)
                        nxt.append(callee)
            frontier = nxt
            depth += 1
        return seen


def enclosing_scope_source(text: str, lineno: int, tree=None) -> str:
    """Source of the innermost function/class whose body spans
    ``lineno`` (1-based) — the scope a required call must live in.
    Pass the SourceFile's already-parsed ``tree`` to honor the
    one-parse-per-file contract; the re-parse is a fallback for raw
    text."""
    if tree is None:
        tree = ast.parse(text)
    best = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.lineno <= lineno <= (node.end_lineno or node.lineno):
                if best is None or node.lineno > best.lineno:
                    best = node
    if best is None:
        return text
    return "\n".join(text.splitlines()[best.lineno - 1:best.end_lineno])
