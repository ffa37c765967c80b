"""Config-key rule: every governed ``*.*`` key is KEY_-bound, read
through a JobConfig accessor, and README-documented.

The port's copy of ``avenir_tpu/analysis/rules_config.py``: one rule
owns every governed namespace (a new namespace joins by adding a prefix
group).  Per governed key:

- a ``KEY_`` constant must bind the literal (no ad-hoc string reads that
  drift from the docs),
- some module must read it through a JobConfig accessor referencing
  that constant,
- the README must document it.

Gauge/metric NAMES reuse the dotted vocabulary but never flow through an
accessor, so they stay out; ``serve.model.<name>.*`` per-model override
keys are derived at runtime and stay out.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .engine import Corpus, Finding, rule

#: the governed namespace groups (regex fragments); the rule checks the
#: union, and a test may check one group's keys alone
NAMESPACE_GROUPS: Dict[str, str] = {
    "durability": r"(?:checkpoint|io|serve\.poison)",
    "telemetry": (r"(?:telemetry|serve\.slo|serve\.pool|serve\.router|"
                  r"serve\.frontend|serve\.drain|serve\.breaker|"
                  r"obs\.sample|flight)"),
    "workflow": r"(?:workflow|dag)",
    "sanitizer": r"(?:sanitize)",
    # the streaming decision service (stream/); the literal
    # dot keeps the legacy `streaming.max.pending.batches` key out
    "stream": r"(?:stream)",
    # the multi-tenant managed model cache (serve/modelcache.py +
    # serve/admission.py): serve.cache.* residency/cold-start/quota keys
    "cache": r"(?:serve\.cache)",
    # host ingest: the parallel-parse pool (core/parparse.py) and the
    # parse-once binary cache (core/ingestcache.py).  Deliberately NOT
    # bare `ingest` — the legacy `ingest.chunk.bytes` /
    # `ingest.error.budget` literals predate the rule and stay out
    "ingest": r"(?:ingest\.parse|ingest\.cache)",
    # the workload harness (workload/): scenario/fleet/SLO
    # keys.  The per-phase `workload.phase.<name>.*` family is derived
    # at runtime (f-strings over declared phase names, like
    # `serve.model.<name>.*`) and is deliberately outside governance —
    # only the scalar workload.* keys are KEY_-bound
    "workload": r"(?:workload)",
    # the fleet observability plane (fleetobs/): spool
    # publisher + cross-process aggregator keys
    "fleetobs": r"(?:fleetobs)",
    # the pod-scale fleet router (serve/fleet): dispatch, feed-watch,
    # autoscale/residency control keys.  Anchored `router` — distinct
    # from the in-process variant router's serve.router.* family
    "router": r"(?:router)",
}

_ACCESSORS = (r"\.(?:get|get_int|get_float|get_boolean|get_list|must|"
              r"must_int|must_float|must_list)\(")


def _const_re(prefixes: str) -> re.Pattern:
    return re.compile(
        r'^(KEY_[A-Z0-9_]+)\s*=\s*"(' + prefixes + r'\.[a-z0-9.]+)"',
        re.MULTILINE)


def _literal_re(prefixes: str) -> re.Pattern:
    return re.compile(
        _ACCESSORS + r'\s*"(' + prefixes + r'\.[a-z0-9.]+)"')


def collect_config_keys(corpus: Corpus,
                        prefixes: str) -> Dict[str, Optional[str]]:
    """Every governed config key under ``prefixes``: bound to a KEY_
    constant, or (a lint violation) read as a bare literal (None)."""
    keys: Dict[str, Optional[str]] = {}
    cre, lre = _const_re(prefixes), _literal_re(prefixes)
    for _rel, sf in corpus.items():
        for m in cre.finditer(sf.text):
            keys.setdefault(m.group(2), m.group(1))
        for m in lre.finditer(sf.text):
            keys.setdefault(m.group(1), None)
    return keys


def config_key_findings(corpus: Corpus, prefixes: str,
                        check_readme: bool = True) -> List[Finding]:
    """The three checks for one namespace group."""
    keys = collect_config_keys(corpus, prefixes)
    out: List[Finding] = []
    texts = [(rel, sf.text) for rel, sf in corpus.items()]

    def _where(needle: str):
        for rel, text in texts:
            idx = text.find(needle)
            if idx >= 0:
                return rel, text[:idx].count("\n") + 1
        return "", 0

    for key, const in sorted(keys.items()):
        if const is None:
            rel, line = _where(f'"{key}"')
            out.append(Finding(
                "config-keys", rel, line,
                f"config key {key!r} read as a bare literal — no KEY_ "
                f"constant binds it",
                hint="declare KEY_... = \"<key>\" and read through it"))
            continue
        accessor = re.compile(
            _ACCESSORS + r"\s*(?:\w+\.)?" + const + r"\b")
        if not any(accessor.search(text) for _rel, text in texts):
            rel, line = _where(f"{const} ")
            out.append(Finding(
                "config-keys", rel, line,
                f"config key {key!r}: {const} never read via a JobConfig "
                f"accessor",
                hint="read the key through config.get*(KEY_...)"))
        if check_readme and key not in corpus.readme:
            rel, line = _where(f'"{key}"')
            out.append(Finding(
                "config-keys", rel, line,
                f"config key {key!r} missing from README",
                hint="document the key in the README key table"))
    return out


@rule("config-keys",
      "every governed config key is KEY_-bound, JobConfig-accessor-read "
      "and README-documented (durability/telemetry/workflow/sanitize "
      "namespaces)")
def _config_keys(corpus: Corpus) -> List[Finding]:
    out: List[Finding] = []
    for _group, prefixes in sorted(NAMESPACE_GROUPS.items()):
        out.extend(config_key_findings(corpus, prefixes))
    # de-dup keys matched by more than one group (serve.poison vs flight
    # never overlap today, but a future group might)
    seen = set()
    uniq = []
    for f in out:
        k = (f.file, f.line, f.message)
        if k not in seen:
            seen.add(k)
            uniq.append(f)
    return uniq
