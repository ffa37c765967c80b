"""avenir-analyze for the port: the unified static-analysis engine,
run over ``avenir_tpu_torch`` itself.

The port's copy of ``avenir_tpu/analysis/``.  The reference's catalog of
17 rules checks the package's own source for the bug classes that hurt
it most — unlocked read-modify-writes, threads with no shutdown path,
raw ingest I/O outside the retry layer, truncating writes outside the
atomic publish layer, config keys that drift from the docs, impure or
unmergeable folds — in the spirit of Engler et al., *"Bugs as Deviant
Behavior"* (SOSP 2001) and Savage et al., *"Eraser"* (TOCS 1997).  Every
table that names a site (a module path, a qualname, a registry key)
names one of this package's sites; a table copied from the reference
would name nothing here and silently turn its rule off.

Shape:

- **one parse per source file** — :class:`~.engine.Corpus` parses every
  package module once and shares the trees across all rules;
- **a rule registry** — every check registers under a stable rule id and
  returns structured :class:`~.engine.Finding` s (rule id, ``file:line``,
  message, fix hint);
- **exclusion registries that require a written reason and fail on
  stale entries** — ``NON_RETRYABLE`` (``core/resilience.py``),
  ``NON_ATOMIC_WRITES`` (``core/io.py``), ``NON_FUSABLE``
  (``core/multiscan.py``), ``NON_DAG_STAGES`` (``core/dag.py``) and the
  ones in :mod:`~.registries`: ``SHARED_UNLOCKED`` (lock discipline),
  ``HOST_SYNC_ALLOWED`` (torch hot-path hygiene), ``UNMANAGED_THREADS``
  (thread lifecycle), ``FOLD_IMPURE_ALLOWED``, ``MERGE_EXEMPT`` and
  ``HOST_TOPOLOGY_ALLOWED`` (the fold-algebra family);
- **a CLI** — ``python -m avenir_tpu_torch analyze [--strict] [--json p]``
  (see :mod:`~.cli`), with a sidecar cache under
  ``.avenir-analyze-torch/`` and the ``--dynamic`` fold certificate on
  ``cuda:0`` (``--device cpu`` on the CPU).

The reference's two JAX rules have torch counterparts in
:mod:`~.rules_torch` (``torch-hot-path``, ``torch-bare-capture``), so the
catalog keeps its 17 rules.
"""

from .engine import (Corpus, Finding, Rule, RULES, all_rule_ids,
                     load_package_corpus, run_rules)
from .registries import ExclusionRegistry

# importing the rule modules registers every rule with the engine
from . import rules_io          # noqa: F401  (io-retry, io-atomic-write)
from . import rules_config      # noqa: F401  (config-keys)
from . import rules_drivers     # noqa: F401  (driver-* / foldspec-*)
from . import rules_serve       # noqa: F401  (flight-anomaly, wire-identity)
from . import rules_concurrency  # noqa: F401  (lock-discipline, thread-*)
from . import rules_torch       # noqa: F401  (torch-hot-path,
#                                              torch-bare-capture)
from . import rules_algebra     # noqa: F401  (fold-purity, merge-closure,
#                                              carry-portability)

__all__ = ["Corpus", "Finding", "Rule", "RULES", "ExclusionRegistry",
           "all_rule_ids", "load_package_corpus", "run_rules"]
