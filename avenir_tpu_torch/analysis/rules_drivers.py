"""Driver-registry rules (project scope: they introspect the real
package through ``avenir_tpu_torch.cli.JOBS``).

The port's copy of ``avenir_tpu/analysis/rules_drivers.py``, over the
port's own job table, fold specs and workflow built-ins:

- **driver-traced** — every registered batch driver's ``run()`` carries
  ``@traced_run`` (the unified tracing surface).
- **driver-counters** — every registered driver's ``run()`` is annotated
  to return ``Counters`` (or sits on ``RETURN_ALLOWED`` with a reason).
- **foldspec-fusable** — every streaming-fold consumer exports a
  shared-scan ``fold_spec`` or sits on ``core.multiscan.NON_FUSABLE``.
- **foldspec-dag** — every FoldSpec exporter is DAG-registrable
  (standard ``run(in, out, mesh)`` surface) or sits on
  ``core.dag.NON_DAG_STAGES``.
- **dag-builtins** — the workflow-only built-in stages honor the traced
  ``run(in, out, mesh) -> Counters`` driver contract, and the per-stage
  manifest template keys are README-documented.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Dict, List, Optional

from .engine import Corpus, Finding, rule
from .registries import ExclusionRegistry

#: run() returns something other than Counters by DESIGN for these
RETURN_ALLOWED: Dict[str, str] = {
    "org.avenir.regress.LogisticRegressionJob":
        "models/regress.py's run returns the convergence status (100 "
        "converged, 101 not yet) that cli.main turns into the exit code "
        "of the runbook's do-while loop; its counters live on "
        "self.counters",
    "org.avenir.reinforce.ReinforcementLearnerTopology":
        "models/streaming.py's run is the long-lived event loop "
        "(topology name and properties file, no output path): it returns "
        "its event Counters unannotated, and takes no mesh",
}


def _driver_classes():
    from ..cli import JOBS
    for fqcn, (modname, clsname, _) in sorted(JOBS.items()):
        mod = importlib.import_module(f"..models.{modname}", __package__)
        yield fqcn, getattr(mod, clsname)


def _class_site(cls):
    """(package-relative file, lineno) of a driver class."""
    try:
        rel = f"models/{cls.__module__.rsplit('.', 1)[-1]}.py"
        _src, line = inspect.getsourcelines(cls)
        return rel, line
    except (OSError, TypeError):
        return f"models/{cls.__module__.rsplit('.', 1)[-1]}.py", 0


@rule("driver-traced",
      "every registered driver's run() carries @traced_run (core.obs)",
      scope="project")
def driver_traced_findings(_corpus: Corpus) -> List[Finding]:
    out: List[Finding] = []
    for fqcn, cls in _driver_classes():
        if not getattr(cls.run, "__obs_traced__", False):
            rel, line = _class_site(cls)
            out.append(Finding(
                "driver-traced", rel, line,
                f"{fqcn}.run() lacks @traced_run",
                hint="decorate run() with core.obs.traced_run"))
    return out


@rule("driver-counters",
      "every registered driver's run() returns Counters (or sits on "
      "RETURN_ALLOWED with a reason)", scope="project")
def driver_counters_findings(_corpus: Corpus) -> List[Finding]:
    reg = ExclusionRegistry("driver-counters", "RETURN_ALLOWED",
                            RETURN_ALLOWED)
    out: List[Finding] = []
    candidates = []
    for fqcn, cls in _driver_classes():
        ann = inspect.signature(cls.run).return_annotation
        name = ann if isinstance(ann, str) else getattr(ann, "__name__",
                                                        ann)
        if name == "Counters":
            continue
        candidates.append(fqcn)
        if reg.excuses(fqcn):
            continue
        rel, line = _class_site(cls)
        out.append(Finding(
            "driver-counters", rel, line,
            f"{fqcn}.run() does not return Counters (annotation: {name})",
            hint="return a Counters snapshot, or add to "
                 "rules_drivers.RETURN_ALLOWED with a reason"))
    out.extend(reg.hygiene_findings(candidates, file_of=lambda k: ""))
    return out


# ---------------------------------------------------------------------------
# shared-scan fusability (NON_FUSABLE)
# ---------------------------------------------------------------------------

def _consumes_streaming_fold(cls) -> bool:
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):  # pragma: no cover - C/builtin classes
        return False
    return "streaming_fold" in src


def foldspec_fusable_findings(
        exclusions: Optional[Dict[str, str]] = None) -> List[Finding]:
    from ..core.multiscan import NON_FUSABLE
    reg = ExclusionRegistry(
        "foldspec-fusable", "NON_FUSABLE",
        NON_FUSABLE if exclusions is None else exclusions)
    out: List[Finding] = []
    candidates = []
    for fqcn, cls in _driver_classes():
        if not _consumes_streaming_fold(cls):
            continue
        if callable(getattr(cls, "fold_spec", None)):
            continue
        candidates.append(cls.__name__)
        if reg.excuses(cls.__name__):
            continue
        rel, line = _class_site(cls)
        out.append(Finding(
            "foldspec-fusable", rel, line,
            f"streaming-fold consumer {fqcn} exports no fold_spec",
            hint="export a shared-scan fold_spec or add the class to "
                 "core.multiscan.NON_FUSABLE with a reason"))
    out.extend(reg.hygiene_findings(candidates, file_of=lambda k: ""))
    return out


@rule("foldspec-fusable",
      "every streaming-fold consumer exports a shared-scan fold_spec or "
      "sits on core.multiscan.NON_FUSABLE with a reason",
      scope="project")
def _foldspec_fusable(_corpus: Corpus) -> List[Finding]:
    return foldspec_fusable_findings()


# ---------------------------------------------------------------------------
# DAG registrability (NON_DAG_STAGES)
# ---------------------------------------------------------------------------

def dag_registrable(cls) -> bool:
    """A class the workflow engine can run as a stage: the standard
    driver surface run(self, in_path, out_path, mesh=...)."""
    run = getattr(cls, "run", None)
    if run is None:
        return False
    params = list(inspect.signature(run).parameters)
    return params[:3] == ["self", "in_path", "out_path"] and "mesh" in params


def foldspec_dag_findings(
        exclusions: Optional[Dict[str, str]] = None) -> List[Finding]:
    from ..core.dag import NON_DAG_STAGES
    reg = ExclusionRegistry(
        "foldspec-dag", "NON_DAG_STAGES",
        NON_DAG_STAGES if exclusions is None else exclusions)
    out: List[Finding] = []
    candidates = []
    for fqcn, cls in _driver_classes():
        if not callable(getattr(cls, "fold_spec", None)):
            continue
        if dag_registrable(cls):
            continue
        candidates.append(cls.__name__)
        if reg.excuses(cls.__name__):
            continue
        rel, line = _class_site(cls)
        out.append(Finding(
            "foldspec-dag", rel, line,
            f"FoldSpec exporter {fqcn} cannot run as a DAG stage "
            f"(non-standard run() surface)",
            hint="fix the run(in, out, mesh) surface or add to "
                 "core.dag.NON_DAG_STAGES with a reason"))
    out.extend(reg.hygiene_findings(candidates, file_of=lambda k: ""))
    return out


@rule("foldspec-dag",
      "every FoldSpec exporter is DAG-registrable or sits on "
      "core.dag.NON_DAG_STAGES with a reason", scope="project")
def _foldspec_dag(_corpus: Corpus) -> List[Finding]:
    return foldspec_dag_findings()


# ---------------------------------------------------------------------------
# workflow built-ins + per-stage manifest template keys
# ---------------------------------------------------------------------------

@rule("dag-builtins",
      "workflow built-in stages honor the traced run(in, out, mesh) -> "
      "Counters contract; per-stage manifest template keys are "
      "README-documented", scope="project")
def dag_builtin_findings(corpus: Corpus) -> List[Finding]:
    from ..core.dag import BUILTIN_STAGES, STAGE_RESERVED
    out: List[Finding] = []
    for name, cls in sorted(BUILTIN_STAGES.items()):
        problems = []
        if not dag_registrable(cls):
            problems.append("non-standard run(in, out, mesh) surface")
        if not getattr(cls.run, "__obs_traced__", False):
            problems.append("run lacks @traced_run")
        ann = inspect.signature(cls.run).return_annotation
        label = ann if isinstance(ann, str) else getattr(ann, "__name__",
                                                         ann)
        if label != "Counters":
            problems.append(f"run() returns {label}, not Counters")
        if problems:
            out.append(Finding(
                "dag-builtins", "core/dag.py", 0,
                f"built-in stage {name}: {'; '.join(problems)}",
                hint="built-ins honor the same driver contract the "
                     "scheduler assumes of every stage"))
    template_keys = ("workflow.stage.<id>.class",) + tuple(
        f"workflow.stage.<id>.{k}" for k in STAGE_RESERVED
        if k != "class")
    for key in template_keys:
        if key not in corpus.readme:
            out.append(Finding(
                "dag-builtins", "core/dag.py", 0,
                f"per-stage manifest key {key!r} missing from README",
                hint="document the template key in the manifest section"))
    return out
