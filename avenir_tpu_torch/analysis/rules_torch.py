"""PyTorch hot-path hygiene rules: the port's counterpart of the
reference's ``rules_jax.py``, one rule for each of its two.

**torch-hot-path** (for ``jax-hot-path``) — no host syncs inside the
registered fold/score hot paths.  The streaming fold's design is that
the per-chunk loop never waits for the card (prefetch overlap, carries
kept on the device); a ``.item()`` / ``.cpu()`` / ``.numpy()`` /
``.tolist()`` / ``torch.cuda.synchronize()`` / ``np.asarray(...)`` /
``float(<non-literal>)`` dropped into one of the :data:`HOT_PATHS`
scopes serializes host and card.  The same table names the functions
that ``utils/graphs.py::GraphedCall`` captures into a CUDA graph, whose
contract is stronger still: a captured function must not read a device
value on the host at all, since a graph cannot.  Deliberate syncs (the
end-of-scan barrier, the checkpoint's carry copy, the server's read of
its answers) sit on ``registries.HOST_SYNC_ALLOWED`` with a written
reason.

**torch-bare-capture** (for ``jax-bare-jit``) — no bare
``GraphedCall(...)`` or ``torch.compile(...)`` on serving/pipeline
paths.  Each build there must ride ``core.telemetry.profiled_build``,
so its first call (the capture, or the compile) is billed to the
``Telemetry / xla.compile.ms`` counter and warmup regressions stay
visible.  A build counts as wrapped when the call is itself an argument
of ``profiled_build(...)``, or when the name it is bound to is handed
to ``profiled_build`` in the same scope.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .engine import Corpus, Finding, ScopedVisitor, dotted_name, rule
from . import registries
from .registries import ExclusionRegistry

#: the registered fold/score hot paths: ``module.py`` -> qualname
#: prefixes whose scopes form the per-chunk / per-batch loop, and the
#: functions captured as CUDA graphs.  A scope matches when its qualname
#: equals a prefix or extends it (``prefix.<nested>``).
HOT_PATHS: Dict[str, Tuple[str, ...]] = {
    # the streamed fold: the copy of a chunk, the fold on the card, the
    # prefetch driver and its worker
    "core/pipeline.py": ("ChunkTransfer", "ChunkFold", "drive_prefetched"),
    # the shared scan's chunk loop and the per-chunk views of its jobs
    "core/multiscan.py": ("MultiScanEngine.run", "ChunkContext"),
    # the serving adapters' per-batch scoring
    "serve/engine.py": ("NaiveBayesAdapter._score",
                        "NaiveBayesAdapter.predict_lines",
                        "MarkovClassifierAdapter.predict_lines"),
    "serve/batcher.py": ("MicroBatcher._run_loop",
                         "MicroBatcher._score_lines",
                         "MicroBatcher._isolate"),
    # captured by GraphedCall (serve/engine.py NaiveBayesAdapter._compiled)
    "models/bayesian.py": ("BayesianPredictor._score_batch",
                           "BayesianPredictor._score_prepared_f32"),
    # captured by GraphedCall (serve/engine.py
    # MarkovClassifierAdapter._compiled)
    "models/markov.py": ("_mmc_pair_log_odds",),
    # captured by GraphedCall (stream/posterior.py PosteriorStore._decide_fn)
    "stream/posterior.py": ("PosteriorStore._decide_fn", "_ucb_decide",
                            "_thompson_decide"),
}

#: attribute calls that read a device value on the host
_SYNC_ATTRS = {"item", "cpu", "numpy", "tolist"}

#: modules where a bare ``GraphedCall``/``torch.compile`` bypasses
#: profiled_build's billing (the serving + pipeline build surfaces)
BARE_CAPTURE_MODULES = ("serve/", "core/pipeline.py", "core/multiscan.py")

#: the build spellings the capture rule patrols
_CAPTURE_CALLS = {"GraphedCall", "torch.compile"}


def _in_hot_path(rel: str, qual: str,
                 hot_paths: Dict[str, Tuple[str, ...]]) -> bool:
    prefixes = hot_paths.get(rel)
    if not prefixes:
        return False
    return any(qual == p or qual.startswith(p + ".") for p in prefixes)


def _sync_call(node: ast.Call) -> Optional[str]:
    """The host-sync token of one call, or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in _SYNC_ATTRS:
            return fn.attr
        if fn.attr == "synchronize":
            dotted = dotted_name(fn)
            return ("torch.cuda.synchronize"
                    if dotted == "torch.cuda.synchronize" else "synchronize")
        if (fn.attr in ("asarray", "array")
                and isinstance(fn.value, ast.Name) and fn.value.id == "np"):
            return f"np.{fn.attr}"
    elif isinstance(fn, ast.Name) and fn.id == "float":
        # float(<device value>) — conservatively flagged on calls whose
        # argument is not a literal
        if node.args and not isinstance(node.args[0], ast.Constant):
            return "float"
    return None


class _SyncScan(ScopedVisitor):
    def __init__(self):
        super().__init__()
        self.sites: List[Tuple[str, int, str]] = []   # (qual, line, call)

    def visit_Call(self, node):
        call = _sync_call(node)
        if call is not None:
            self.sites.append((self.qual(), node.lineno, call))
        self.generic_visit(node)


def torch_hot_path_findings(corpus: Corpus, hot_paths=None,
                            exclusions=None) -> List[Finding]:
    hp = HOT_PATHS if hot_paths is None else hot_paths
    reg = ExclusionRegistry(
        "torch-hot-path", "HOST_SYNC_ALLOWED",
        registries.HOST_SYNC_ALLOWED if exclusions is None
        else exclusions)
    out: List[Finding] = []
    candidates: List[str] = []
    for rel, sf in corpus.items():
        if rel not in hp:
            continue
        scan = _SyncScan()
        scan.visit(sf.tree)
        for qual, line, call in scan.sites:
            if not _in_hot_path(rel, qual, hp):
                continue
            key = f"{rel}:{qual}:{call}"
            candidates.append(key)
            if reg.excuses(key):
                continue
            out.append(Finding(
                "torch-hot-path", rel, line,
                f"host sync {call}() inside registered hot path {qual}",
                hint="keep the per-chunk/per-batch loop async (a host "
                     "read of a device value serializes the prefetch "
                     "overlap, and breaks a CUDA graph capture), or add "
                     f"{key!r} to analysis.registries.HOST_SYNC_ALLOWED "
                     "with a reason"))
    out.extend(reg.hygiene_findings(candidates))
    return out


@rule("torch-hot-path",
      "no undocumented host syncs (.item()/.cpu()/.numpy()/.tolist()/"
      "torch.cuda.synchronize/np.asarray/float) inside registered "
      "fold/score hot paths and CUDA-graph captured functions")
def _torch_hot_path(corpus: Corpus) -> List[Finding]:
    return torch_hot_path_findings(corpus)


class _CaptureScan(ScopedVisitor):
    """``GraphedCall(...)``/``torch.compile(...)`` call sites with the
    name each is bound to, and per scope the names handed to
    ``profiled_build`` and the build calls nested inside one."""

    def __init__(self):
        super().__init__()
        self.sites: List[Tuple[str, int, ast.Call, Optional[str]]] = []
        self.billed_names: Dict[str, set] = {}
        self.billed_nodes: set = set()

    @staticmethod
    def _spelling(call: ast.Call) -> Optional[str]:
        dotted = dotted_name(call.func)
        if dotted is None:
            return None
        if dotted in _CAPTURE_CALLS:
            return dotted
        if dotted.rsplit(".", 1)[-1] == "GraphedCall":
            return "GraphedCall"
        return None

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call) and self._spelling(node.value):
            name = (node.targets[0].id if len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name) else None)
            self.sites.append((self.qual(), node.value.lineno, node.value,
                               name))
            # the call's own arguments may hold further builds
            for child in ast.iter_child_nodes(node.value):
                self.visit(child)
            return
        self.generic_visit(node)

    def visit_Call(self, node):
        dotted = dotted_name(node.func) or ""
        if dotted.rsplit(".", 1)[-1] == "profiled_build" and node.args:
            first = node.args[0]
            if isinstance(first, ast.Name):
                self.billed_names.setdefault(self.qual(), set()).add(
                    first.id)
            elif isinstance(first, ast.Call):
                self.billed_nodes.add(id(first))
        elif self._spelling(node) and not any(
                s[2] is node for s in self.sites):
            self.sites.append((self.qual(), node.lineno, node, None))
        self.generic_visit(node)


def torch_bare_capture_findings(corpus: Corpus,
                                modules=BARE_CAPTURE_MODULES
                                ) -> List[Finding]:
    out: List[Finding] = []
    for rel, sf in corpus.items():
        if not (rel.startswith(tuple(m for m in modules
                                     if m.endswith("/")))
                or rel in modules):
            continue
        scan = _CaptureScan()
        scan.visit(sf.tree)
        for qual, line, node, name in scan.sites:
            if id(node) in scan.billed_nodes:
                continue
            if name is not None and name in scan.billed_names.get(
                    qual, ()):
                continue
            what = _CaptureScan._spelling(node)
            out.append(Finding(
                "torch-bare-capture", rel, line,
                f"bare {what} in {qual} on a serving/pipeline path "
                f"bypasses profiled_build build billing",
                hint="wrap with core.telemetry.profiled_build so the "
                     "capture bills to Telemetry/xla.compile.ms"))
    return out


@rule("torch-bare-capture",
      "no bare GraphedCall/torch.compile on serving/pipeline paths "
      "(profiled_build bills every build)")
def _torch_bare_capture(corpus: Corpus) -> List[Finding]:
    return torch_bare_capture_findings(corpus)
