"""Distributed-readiness rules: the fold-algebra family.

The port's copy of ``avenir_tpu/analysis/rules_algebra.py``, with its
root tables naming the port's fold machinery and its topology reads
spelled in torch.  Multi-card execution assumes every registered
fold/merge is a true commutative monoid — a mesh's shards fold apart and
their tables are summed (``ops.counting.sharded_reduce_resident``), and
multi-process aggregation is "just a fold" over mergeable snapshots.
Non-commutative / impure reducers are a well-documented
silent-corruption class (Xiao et al., *"Nondeterminism in MapReduce
Considered Harmful?"*, ICSE 2014), so these rules prove the assumption
statically; the runtime twin (:mod:`avenir_tpu_torch.core.algebra`,
``analyze --dynamic``) property-tests it on real folds.

- **fold-purity** — code reachable (via the engine's dataflow pass)
  from any FoldSpec ``encode``/``finalize``, any bound ``local_fn``, or
  the pipeline fold machinery must not read wall clock, unseeded RNG,
  env vars, or mutable process-global state: host-local
  nondeterminism that silently diverges across hosts.  Deliberate
  observability bookkeeping sits on
  :data:`~.registries.FOLD_IMPURE_ALLOWED` with a written reason.
- **merge-closure** — every class exporting ``state_dict`` pairs it
  with ``from_state`` + a ``merge`` path (or sits on
  :data:`~.registries.MERGE_EXEMPT`), and every section written into a
  mergeable telemetry snapshot is handled by ``merge_snapshots`` (or
  sits on ``core.telemetry.SNAPSHOT_NON_MERGED``) — a new snapshot
  field can never be silently dropped by the multi-host fold.  The same
  closure holds between ``LatencyHistogram.state_dict`` and the
  bucket-state merge.
- **carry-portability** — code reachable from carry-producing scopes
  (FoldSpec classes, the fold/checkpoint machinery) must not read host
  topology (card counts, process ranks, cpu counts, hostnames): a carry
  whose dtype/shape bakes in per-host facts cannot resume or merge on a
  differently-sized mesh.  Deliberate topology surfaces (mesh
  construction) sit on :data:`~.registries.HOST_TOPOLOGY_ALLOWED`.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from .engine import Corpus, Finding, dotted_name, rule
from . import registries
from .registries import ExclusionRegistry

#: fold-machinery scopes rooted in addition to discovered FoldSpec
#: subclasses: the pipeline's fold step and its in-place carry add, the
#: mesh's shard-fold-and-sum (the counterpart of the reference's jitted
#: ``_fold_fns`` pair), the shared-scan chunk loop, and the per-chunk
#: context views.
PIPELINE_FOLD_ROOTS: Dict[str, Tuple[str, ...]] = {
    "core/pipeline.py": ("ChunkFold.fold", "add_into"),
    "ops/counting.py": ("sharded_reduce_resident",),
    "core/multiscan.py": ("MultiScanEngine.run", "ChunkContext"),
}

#: carry-producing scopes beyond the FoldSpec classes themselves: fold
#: carry construction/seeding/snapshot and the checkpoint capture path.
CARRY_ROOTS: Dict[str, Tuple[str, ...]] = {
    "core/pipeline.py": ("ChunkFold", "streaming_fold",
                         "AsyncCheckpointSaver"),
    "core/multiscan.py": ("MultiScanEngine.run",),
    "core/checkpoint.py": ("CheckpointToken", "StreamCheckpointer.token",
                           "StreamCheckpointer.save"),
}

#: wall-clock reads that diverge across hosts
WALL_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today", "date.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
})

#: RNG namespaces whose module-level draws are process-seeded (hosts
#: draw different streams); a seeded ``default_rng(seed)`` passes.
RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")

#: host-topology reads that bake per-host facts into values: the torch
#: spellings of the reference's ``jax.devices``/``jax.device_count``/
#: ``jax.process_index``/``jax.process_count``, and the host reads
HOST_TOPOLOGY_CALLS = frozenset({
    "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.distributed.get_rank", "torch.distributed.get_world_size",
    "dist.get_rank", "dist.get_world_size",
    "os.cpu_count", "multiprocessing.cpu_count", "socket.gethostname",
    "platform.node", "os.uname",
})


# ---------------------------------------------------------------------------
# root discovery (shared by fold-purity and carry-portability)
# ---------------------------------------------------------------------------

def _is_foldspec_class(bases: Sequence[str]) -> bool:
    return any(b.endswith("FoldSpec") for b in bases)


def foldspec_classes(corpus: Corpus) -> List[Tuple[str, str]]:
    """(rel, class name) of every FoldSpec subclass in the corpus."""
    df = corpus.dataflow()
    out = []
    for rel, idx in sorted(df.modules.items()):
        for cls, bases in sorted(idx.class_bases.items()):
            if _is_foldspec_class(bases):
                out.append((rel, cls))
    return out


def _local_fn_roots(corpus: Corpus) -> List[Tuple[str, str]]:
    """Functions bound as a spec's ``local_fn`` (``self.local_fn = f``
    in __init__ or a class-level ``local_fn = f``) — the fold
    bodies themselves."""
    df = corpus.dataflow()
    roots = []
    spec_classes = {(rel, cls) for rel, cls in foldspec_classes(corpus)}
    for rel, sf in corpus.items():
        idx = df.modules[rel]
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if (rel, node.name) not in spec_classes:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                for t in sub.targets:
                    name = None
                    if (isinstance(t, ast.Attribute)
                            and t.attr == "local_fn"):
                        name = t.attr
                    elif isinstance(t, ast.Name) and t.id == "local_fn":
                        name = t.id
                    if name is None or not isinstance(sub.value,
                                                      ast.Name):
                        continue
                    fname = sub.value.id
                    if fname in idx.functions:
                        roots.append((rel, fname))
                    elif fname in idx.from_imports:
                        trel, orig = idx.from_imports[fname]
                        roots.append((trel, orig))
    return roots


def fold_roots(corpus: Corpus,
               extra: Optional[Dict[str, Tuple[str, ...]]] = None
               ) -> List[Tuple[str, str]]:
    """Every (rel, qual) the fold-purity rule treats as a root: the
    encode/finalize of each FoldSpec subclass, each bound ``local_fn``,
    and the pipeline fold machinery."""
    df = corpus.dataflow()
    roots: List[Tuple[str, str]] = []
    for rel, cls in foldspec_classes(corpus):
        roots.extend(df.expand_prefixes(
            rel, (f"{cls}.encode", f"{cls}.finalize",
                  f"{cls}.<class>")))
    roots.extend(_local_fn_roots(corpus))
    table = PIPELINE_FOLD_ROOTS if extra is None else extra
    for rel, prefixes in table.items():
        roots.extend(df.expand_prefixes(rel, prefixes))
    return sorted(set(roots))


# ---------------------------------------------------------------------------
# impure-site scanning
# ---------------------------------------------------------------------------

def _direct_body_walk(fn_node):
    """Walk a function's own body, NOT descending into nested function
    defs (each nested def is a separate dataflow node, reached through
    the parent's implicit nested edge)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _impure_call_sites(fn_node) -> List[Tuple[str, int]]:
    """(token, lineno) wall-clock / RNG / env-var read sites in one
    function body."""
    sites: List[Tuple[str, int]] = []
    for node in _direct_body_walk(fn_node):
        if isinstance(node, ast.Call):
            dotted = dotted_name(node.func)
            if dotted is None:
                continue
            if dotted in WALL_CLOCK_CALLS:
                sites.append((dotted, node.lineno))
            elif dotted.rsplit(".", 1)[-1] == "default_rng":
                # a SEEDED generator is deterministic and fine; only a
                # default (OS-entropy) construction diverges per host
                if not node.args and not node.keywords:
                    sites.append((dotted, node.lineno))
            elif dotted.startswith(RNG_PREFIXES):
                sites.append((dotted, node.lineno))
            elif dotted in ("os.getenv", "os.environ.get"):
                sites.append((dotted, node.lineno))
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Load)
              and dotted_name(node.value) == "os.environ"):
            sites.append(("os.environ", node.lineno))
    return sites


def fold_purity_findings(corpus: Corpus,
                         exclusions: Optional[Dict[str, str]] = None,
                         extra_roots=None) -> List[Finding]:
    reg = ExclusionRegistry(
        "fold-purity", "FOLD_IMPURE_ALLOWED",
        registries.FOLD_IMPURE_ALLOWED if exclusions is None
        else exclusions)
    df = corpus.dataflow()
    reached = df.reachable(fold_roots(corpus, extra=extra_roots))
    out: List[Finding] = []
    candidates: List[str] = []
    for rel, qual in sorted(reached):
        info = df.function(rel, qual)
        if info is None:
            continue
        idx = df.modules[rel]
        sites = list(_impure_call_sites(info.node))
        for g in sorted((info.global_reads | info.global_writes)
                        & idx.effectively_mutable_globals()):
            sites.append((f"global:{g}", info.node.lineno))
        for token, line in sites:
            key = f"{rel}:{qual}:{token}"
            if key in candidates:
                continue
            candidates.append(key)
            if reg.excuses(key):
                continue
            what = (f"reads mutable process-global "
                    f"'{token.partition(':')[2]}'"
                    if token.startswith("global:")
                    else f"calls {token}()")
            out.append(Finding(
                "fold-purity", rel, line,
                f"fold-reachable {qual} {what}: host-local "
                f"nondeterminism diverges across hosts (multi-host "
                f"folds silently corrupt — Xiao ICSE 2014)",
                hint="make the fold path deterministic (seeded RNG, "
                     "config-passed values), or add "
                     f"{key!r} to analysis.registries."
                     "FOLD_IMPURE_ALLOWED with a reason"))
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("fold-purity",
      "code reachable from FoldSpec encode/finalize, bound local_fns, "
      "or the pipeline fold machinery reads no wall clock, unseeded RNG, "
      "env vars, or mutable globals (FOLD_IMPURE_ALLOWED excludes)")
def _fold_purity(corpus: Corpus) -> List[Finding]:
    return fold_purity_findings(corpus)


# ---------------------------------------------------------------------------
# merge-closure
# ---------------------------------------------------------------------------

def _find_function(tree, name: str, cls: Optional[str] = None):
    """The (possibly method) FunctionDef named ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and cls and node.name == cls:
            for sub in node.body:
                if (isinstance(sub, ast.FunctionDef)
                        and sub.name == name):
                    return sub
        elif (cls is None and isinstance(node, ast.FunctionDef)
              and node.name == name):
            return node
    return None


def _written_sections(fn_node) -> Dict[str, int]:
    """TOP-LEVEL snapshot sections a builder writes: the first (outer)
    dict literal's keys plus ``snap["X"] = ...`` subscript-assign keys
    -> lineno.  Nested per-entry dicts (e.g. an exemplar record) are
    values INSIDE a section, not sections."""
    out: Dict[str, int] = {}
    if fn_node is None:
        return out
    first_dict = None
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Dict):
            if first_dict is None or node.lineno < first_dict.lineno:
                first_dict = node
    if first_dict is not None:
        for k in first_dict.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out.setdefault(k.value, k.lineno)
    for node in ast.walk(fn_node):
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)):
            sl = node.targets[0].slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                out.setdefault(sl.value, node.lineno)
    return out


def _handled_keys(fn_node) -> set:
    """Keys a merge function genuinely CARRIES: literal keys of its
    dict literals (the returned/accumulated output shape), string args
    of ``.get(...)`` reads, and plain-Assign subscript stores
    (``out["x"] = ...``).  Deliberately NOT every string constant and
    NOT AugAssign subscripts: ``cur["count"] += s["count"]`` mutates a
    nested entry field, and a future top-level section named "count"
    must still be reported as dropped."""
    out = set()
    if fn_node is None:
        return out
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value,
                                                              str):
                    out.add(k.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value)
        elif (isinstance(node, ast.Assign)
              and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Subscript)):
            sl = node.targets[0].slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value,
                                                           str):
                out.add(sl.value)
    return out


def merge_closure_findings(corpus: Corpus,
                           exclusions: Optional[Dict[str, str]] = None,
                           non_merged: Optional[Dict[str, str]] = None
                           ) -> List[Finding]:
    reg = ExclusionRegistry(
        "merge-closure", "MERGE_EXEMPT",
        registries.MERGE_EXEMPT if exclusions is None else exclusions)
    df = corpus.dataflow()
    out: List[Finding] = []

    # (a) state_dict exporters pair with from_state + merge
    candidates: List[str] = []
    for rel, idx in sorted(df.modules.items()):
        for cls, methods in sorted(idx.classes.items()):
            if "state_dict" not in methods:
                continue
            missing = [m for m in ("from_state", "merge")
                       if m not in methods]
            if not missing:
                continue
            candidates.append(cls)
            if reg.excuses(cls):
                continue
            out.append(Finding(
                "merge-closure", rel, idx.class_lines.get(cls, 0),
                f"{cls} exports state_dict without {'/'.join(missing)}: "
                f"its snapshots cannot round-trip or fold across "
                f"processes",
                hint="pair state_dict with from_state + merge (the "
                     "LatencyHistogram contract), or add the class to "
                     "analysis.registries.MERGE_EXEMPT with a reason"))
    out.extend(reg.hygiene_findings(candidates, file_of=lambda k: ""))

    # (b) snapshot-section closure: everything the builders write,
    # merge_snapshots must handle (or SNAPSHOT_NON_MERGED documents)
    tele = next((sf for rel, sf in corpus.items()
                 if rel.endswith("telemetry.py")), None)
    obs = next((sf for rel, sf in corpus.items()
                if rel.endswith("obs.py")), None)
    if tele is not None:
        if non_merged is None:
            try:
                from ..core.telemetry import SNAPSHOT_NON_MERGED
                non_merged = SNAPSHOT_NON_MERGED
            except ImportError:      # fixture corpus without the package
                non_merged = {}
        nreg = ExclusionRegistry("merge-closure", "SNAPSHOT_NON_MERGED",
                                 non_merged)
        sections: Dict[str, int] = {}
        sections.update(_written_sections(
            _find_function(tele.tree, "build_snapshot")))
        if obs is not None:
            sections.update(_written_sections(
                _find_function(obs.tree, "mergeable_snapshot",
                               cls="Metrics")))
        handled = _handled_keys(
            _find_function(tele.tree, "merge_snapshots"))
        ncand = []
        for sec, line in sorted(sections.items()):
            if sec in handled:
                continue
            ncand.append(sec)
            if nreg.excuses(sec):
                continue
            out.append(Finding(
                "merge-closure", tele.rel, line,
                f"snapshot section {sec!r} is written by the snapshot "
                f"builders but silently dropped by merge_snapshots",
                hint="merge the section (sum/add/latest-wins), or add "
                     "it to core.telemetry.SNAPSHOT_NON_MERGED with a "
                     "reason"))
        out.extend(nreg.hygiene_findings(ncand,
                                         file_of=lambda k: tele.rel))

        # (c) histogram-state closure: LatencyHistogram.state_dict keys
        # all appear in the bucket-state merge
        if obs is not None:
            st = _written_sections(_find_function(
                obs.tree, "state_dict", cls="LatencyHistogram"))
            hm = _handled_keys(_find_function(tele.tree,
                                              "_merge_hist_state"))
            if hm:
                for k, line in sorted(st.items()):
                    if k not in hm and not k.isdigit():
                        out.append(Finding(
                            "merge-closure", obs.rel, line,
                            f"LatencyHistogram.state_dict key {k!r} is "
                            f"not handled by _merge_hist_state: merged "
                            f"histogram states silently drop it",
                            hint="extend _merge_hist_state (and the "
                                 "merge tests) for the new key"))
    return out


@rule("merge-closure",
      "state_dict exporters pair with from_state+merge; every snapshot "
      "section/histogram-state key survives merge_snapshots (or is on "
      "SNAPSHOT_NON_MERGED with a reason)")
def _merge_closure(corpus: Corpus) -> List[Finding]:
    return merge_closure_findings(corpus)


# ---------------------------------------------------------------------------
# carry-portability
# ---------------------------------------------------------------------------

def carry_roots(corpus: Corpus,
                extra: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> List[Tuple[str, str]]:
    df = corpus.dataflow()
    roots: List[Tuple[str, str]] = []
    for rel, cls in foldspec_classes(corpus):
        roots.extend(df.expand_prefixes(rel, (cls,)))
    table = CARRY_ROOTS if extra is None else extra
    for rel, prefixes in table.items():
        roots.extend(df.expand_prefixes(rel, prefixes))
    return sorted(set(roots))


def carry_portability_findings(
        corpus: Corpus,
        exclusions: Optional[Dict[str, str]] = None,
        extra_roots=None) -> List[Finding]:
    reg = ExclusionRegistry(
        "carry-portability", "HOST_TOPOLOGY_ALLOWED",
        registries.HOST_TOPOLOGY_ALLOWED if exclusions is None
        else exclusions)
    df = corpus.dataflow()
    reached = df.reachable(carry_roots(corpus, extra=extra_roots))
    out: List[Finding] = []
    candidates: List[str] = []
    for rel, qual in sorted(reached):
        info = df.function(rel, qual)
        if info is None:
            continue
        for node in _direct_body_walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted not in HOST_TOPOLOGY_CALLS:
                continue
            key = f"{rel}:{qual}:{dotted}"
            if key in candidates:
                continue
            candidates.append(key)
            if reg.excuses(key):
                continue
            out.append(Finding(
                "carry-portability", rel, node.lineno,
                f"carry-producing {qual} reads host topology via "
                f"{dotted}(): a carry sized/indexed by per-host facts "
                f"cannot resume or merge on a different pod shape",
                hint="derive carry dtypes/shapes from data caps and "
                     "config only, or add "
                     f"{key!r} to analysis.registries."
                     "HOST_TOPOLOGY_ALLOWED with a reason"))
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("carry-portability",
      "carry-producing code (FoldSpec classes, fold/checkpoint "
      "machinery) reads no host topology — carries stay valid across "
      "pod shapes (HOST_TOPOLOGY_ALLOWED excludes)")
def _carry_portability(corpus: Corpus) -> List[Finding]:
    return carry_portability_findings(corpus)
