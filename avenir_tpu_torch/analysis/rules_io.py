"""I/O rules: retry coverage on the ingest path, atomic publish
coverage package-wide.

The port's copy of ``avenir_tpu/analysis/rules_io.py``:

- **io-retry** — every raw I/O call site (``open``, ``subprocess.*``,
  ``os.fdopen``/``tempfile.mkstemp``, redis commands) in the ingest-path
  modules must run under ``core.resilience.with_retries`` (directly, or
  as a helper invoked through it) or sit on
  ``core.resilience.NON_RETRYABLE`` with a written reason.  The port's
  ingest path also builds its CUDA kernels (``ops/_build.py``, ``nvcc``
  at first use), as the native ingest builds its C library.
- **io-atomic-write** — every truncate-mode write (``open``/
  ``os.fdopen`` with a ``w*`` mode) anywhere in the package must live
  inside the atomic publish primitives (``core.io.OutputWriter`` /
  ``core.io.atomic_write_text``) or sit on ``core.io.NON_ATOMIC_WRITES``
  with a written reason.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .engine import Corpus, Finding, ScopedVisitor, rule
from .registries import ExclusionRegistry

#: the ingest-path modules the retry lint patrols
INGEST_MODULES = [
    "core/io.py",
    "core/config.py",
    "core/pipeline.py",
    "core/binning.py",
    "core/multiscan.py",
    "core/checkpoint.py",
    "core/resilience.py",
    "native/__init__.py",
    "ops/_build.py",
    "models/streaming.py",
]

#: call spellings that count as raw I/O
RAW_NAME_CALLS = {"open"}
RAW_ATTR_CALLS = {
    ("subprocess", "run"), ("subprocess", "Popen"),
    ("subprocess", "check_output"), ("subprocess", "check_call"),
    ("os", "fdopen"), ("tempfile", "mkstemp"),
    ("redis", "Redis"),
}

#: redis network commands: ANY ``<expr>.<cmd>(...)`` call with one of
#: these attribute names is a network round trip (the redis-py client
#: surface the transports use) — patrolled in the ingest modules like
#: every other raw I/O site.  The FakeRedis double DEFINES these names
#: but never calls them on another object, so it stays clean.
RAW_NET_ATTR_NAMES = {
    "rpop", "lpush", "llen", "lrange",
    "xadd", "xread", "xreadgroup", "xack", "xrange", "xlen",
    "xgroup_create", "xpending",
}

#: quals that ARE the atomic publish layer (writes inside them stage to
#: a temp path and land via fsync + os.replace)
ATOMIC_PRIMITIVES = ("core/io.py:atomic_write_text",
                     "core/io.py:atomic_write_bytes",
                     "core/io.py:OutputWriter.")


class _RetryScan(ScopedVisitor):
    """Raw I/O call sites + with_retries wrapper/invoked-helper names."""

    def __init__(self):
        super().__init__()
        self.raw_sites: Dict[str, List[int]] = {}
        self.wrapper_funcs = set()   # funcs whose body calls with_retries
        self.retry_invoked = set()   # helper names passed to with_retries

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id == "open":
                self.raw_sites.setdefault(self.qual(), []).append(
                    node.lineno)
            elif fn.id == "with_retries":
                self.wrapper_funcs.add(self.qual())
                if node.args and isinstance(node.args[0], ast.Name):
                    self.retry_invoked.add(node.args[0].id)
        elif isinstance(fn, ast.Attribute):
            base = fn.value
            if (isinstance(base, ast.Name)
                    and (base.id, fn.attr) in RAW_ATTR_CALLS):
                self.raw_sites.setdefault(self.qual(), []).append(
                    node.lineno)
            elif fn.attr in RAW_NET_ATTR_NAMES:
                # a redis network command on any client expression
                self.raw_sites.setdefault(self.qual(), []).append(
                    node.lineno)
            if fn.attr == "with_retries":
                self.wrapper_funcs.add(self.qual())
                if node.args and isinstance(node.args[0], ast.Name):
                    self.retry_invoked.add(node.args[0].id)
        self.generic_visit(node)


def scan_ingest_io(corpus: Corpus,
                   modules=None) -> Tuple[Dict[str, List[int]], set]:
    """``(sites, wrapped)``: every raw I/O call site on the ingest path
    keyed ``module.py:qualname`` -> line numbers, and the subset keys
    considered retry-covered (the scan the legacy
    ``test_retry_wrappers_exist`` guards)."""
    sites: Dict[str, List[int]] = {}
    wrapped = set()
    retry_invoked = set()
    per_module = {}
    for rel in (INGEST_MODULES if modules is None else modules):
        sf = corpus.get(rel)
        if sf is None:
            continue
        scan = _RetryScan()
        scan.visit(sf.tree)
        per_module[rel] = scan
        retry_invoked |= scan.retry_invoked
    for rel, scan in per_module.items():
        for qual, lines in scan.raw_sites.items():
            key = f"{rel}:{qual}"
            sites[key] = lines
            leaf = qual.rsplit(".", 1)[-1]
            if qual in scan.wrapper_funcs or leaf in retry_invoked:
                wrapped.add(key)
    return sites, wrapped


def io_retry_findings(corpus: Corpus,
                      exclusions: Optional[Dict[str, str]] = None,
                      modules=None) -> List[Finding]:
    from ..core.resilience import NON_RETRYABLE
    reg = ExclusionRegistry(
        "io-retry", "NON_RETRYABLE",
        NON_RETRYABLE if exclusions is None else exclusions)
    sites, wrapped = scan_ingest_io(corpus, modules=modules)
    out: List[Finding] = []
    for key, lines in sorted(sites.items()):
        if key in wrapped or reg.excuses(key):
            continue
        out.append(Finding(
            "io-retry", key.split(":", 1)[0], lines[0],
            f"raw I/O call site {key} (lines {lines}) on the ingest path "
            f"runs outside with_retries",
            hint="wrap in core.resilience.with_retries or add to "
                 "core.resilience.NON_RETRYABLE with a reason"))
    candidates = [k for k in sites if k not in wrapped]
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("io-retry",
      "raw I/O on the ingest path is retry-wrapped or excluded with a "
      "reason (core.resilience.NON_RETRYABLE)")
def _io_retry(corpus: Corpus) -> List[Finding]:
    return io_retry_findings(corpus)


# ---------------------------------------------------------------------------
# io-atomic-write
# ---------------------------------------------------------------------------

class _WriteScan(ScopedVisitor):
    """``open``/``os.fdopen`` calls whose mode argument is a ``w*``
    constant (truncate-rewrite: the torn-on-crash shape) or a
    non-constant expression (flagged conservatively).  Read-mode and
    append-mode calls pass."""

    def __init__(self):
        super().__init__()
        self.sites: Dict[str, List[int]] = {}

    @staticmethod
    def _truncating(node) -> bool:
        mode = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if mode is None:
            return False                      # default: read
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value.startswith("w")
        return True                           # dynamic mode: flag it

    def visit_Call(self, node):
        fn = node.func
        is_write = False
        if isinstance(fn, ast.Name) and fn.id == "open":
            is_write = self._truncating(node)
        elif (isinstance(fn, ast.Attribute) and fn.attr == "fdopen"
              and isinstance(fn.value, ast.Name)
              and fn.value.id == "os"):
            is_write = self._truncating(node)
        if is_write:
            self.sites.setdefault(self.qual(), []).append(node.lineno)
        self.generic_visit(node)


def scan_truncate_writes(corpus: Corpus) -> Dict[str, List[int]]:
    """Every truncate-mode write site in the corpus, keyed
    ``module.py:qualname`` -> line numbers."""
    sites: Dict[str, List[int]] = {}
    for rel, sf in corpus.items():
        scan = _WriteScan()
        scan.visit(sf.tree)
        for qual, lines in scan.sites.items():
            sites[f"{rel}:{qual}"] = lines
    return sites


def is_atomic_site(key: str) -> bool:
    return key.startswith(ATOMIC_PRIMITIVES)


def io_atomic_findings(corpus: Corpus,
                       exclusions: Optional[Dict[str, str]] = None
                       ) -> List[Finding]:
    from ..core.io import NON_ATOMIC_WRITES
    reg = ExclusionRegistry(
        "io-atomic-write", "NON_ATOMIC_WRITES",
        NON_ATOMIC_WRITES if exclusions is None else exclusions)
    sites = scan_truncate_writes(corpus)
    out: List[Finding] = []
    for key, lines in sorted(sites.items()):
        if is_atomic_site(key) or reg.excuses(key):
            continue
        out.append(Finding(
            "io-atomic-write", key.split(":", 1)[0], lines[0],
            f"truncate-mode write {key} (lines {lines}) outside the "
            f"atomic publish layer (OutputWriter / atomic_write_text)",
            hint="route through core.io.atomic_write_text or add to "
                 "core.io.NON_ATOMIC_WRITES with a reason"))
    candidates = [k for k in sites if not is_atomic_site(k)]
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("io-atomic-write",
      "truncate-mode writes live inside the atomic publish layer or on "
      "core.io.NON_ATOMIC_WRITES with a reason")
def _io_atomic(corpus: Corpus) -> List[Finding]:
    return io_atomic_findings(corpus)
