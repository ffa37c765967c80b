"""SLO-envelope verdicts: judge a run against its declared envelope.

Each phase's :class:`~avenir_tpu_torch.workload.scenario.Envelope` turns into
a list of named checks (p99 ceiling, error/shed fraction ceilings,
dropped-innocents ceiling, deferred-fraction ceiling) evaluated over the
fleet's intended-start latency samples; the run-level compile-flatness
gate compares the serve tier's scorer-compilation count after warmup
with the count at run end (a steady-state traffic mix must not compile —
the serve tier's invariant, enforceable per scenario).

The verdict is one JSON document (written atomically — a crashed run
never leaves a half-verdict that reads as a pass) and one exit code:
``--assert`` maps any violated check to a nonzero exit naming the
violating phase, and fires exactly one flight-recorder dump
(``flight-workload-<scenario>-*.jsonl``) carrying the violating phase's
summary, its merged telemetry snapshot, and the worst-offender trace
exemplar — the black box for "the envelope broke, start HERE".
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..core import flight
from ..core.io import atomic_write_text
from .driver import PhaseStats
from .scenario import Scenario

VERDICT_VERSION = 1


class Check:
    """One envelope dimension's evaluation: declared limit vs observed
    value, and whether the observation stayed inside the envelope."""

    __slots__ = ("key", "limit", "actual", "ok")

    def __init__(self, key: str, limit, actual, ok: bool):
        self.key = key
        self.limit = limit
        self.actual = actual
        self.ok = bool(ok)

    def as_dict(self) -> dict:
        return {"key": self.key, "limit": self.limit,
                "actual": self.actual, "ok": self.ok}


def _ceiling(key: str, limit: Optional[float],
             actual: Optional[float]) -> Optional[Check]:
    if limit is None:
        return None
    if actual is None:
        # an envelope over zero samples is vacuously met only for
        # fraction checks; a declared p99 ceiling with no samples is a
        # broken run and must fail loudly
        return Check(key, limit, None, False)
    return Check(key, limit, round(float(actual), 4),
                 float(actual) <= float(limit))


def evaluate_phase(scenario: Scenario, phase_name: str,
                   stats: PhaseStats) -> List[Check]:
    """The declared checks for one phase (absent envelope keys add no
    checks — scenarios constrain only what they claim)."""
    spec = next(p for p in scenario.phases if p.name == phase_name)
    env = spec.envelope
    checks: List[Check] = []
    for c in (
            _ceiling("slo.p99.ms", env.p99_ms, stats.percentile_ms(0.99)),
            _ceiling("slo.error.max.fraction", env.error_max_fraction,
                     stats.fraction("error") + stats.fraction("timeout")),
            _ceiling("slo.shed.max.fraction", env.shed_max_fraction,
                     stats.fraction("shed")),
            _ceiling("slo.deferred.max.fraction",
                     env.deferred_max_fraction,
                     stats.fraction("deferred"))):
        if c is not None:
            checks.append(c)
    if env.innocents_dropped_max is not None:
        checks.append(Check(
            "slo.innocents.dropped.max", env.innocents_dropped_max,
            stats.innocents_dropped,
            stats.innocents_dropped <= env.innocents_dropped_max))
    return checks


def evaluate_run(scenario: Scenario, per_phase: Dict[str, PhaseStats],
                 compiles_after_warmup: Optional[int] = None,
                 compiles_at_end: Optional[int] = None,
                 usage_after_warmup: Optional[dict] = None,
                 usage_at_end: Optional[dict] = None,
                 cycles_after_warmup: Optional[int] = None,
                 cycles_at_end: Optional[int] = None) -> dict:
    """The whole run's verdict document: per-phase summaries + checks,
    the run-level compile-flatness and resource-leak gates, and the
    overall pass flag.

    ``usage_*`` are :func:`~avenir_tpu_torch.workload.runner.process_usage`
    samples (``{"fds": int|None, "rss_mb": float|None}``) and
    ``cycles_*`` the model cache's cumulative demote count — soak
    profiles gate on their growth between the post-warmup baseline and
    run end.  A declared ceiling the platform cannot measure fails
    loudly (same contract as a p99 ceiling over zero samples)."""
    phases = []
    violations: List[dict] = []
    for spec in scenario.phases:
        stats = per_phase[spec.name]
        checks = evaluate_phase(scenario, spec.name, stats)
        ok = all(c.ok for c in checks)
        phases.append({"name": spec.name, "ok": ok,
                       "summary": stats.summary(),
                       "checks": [c.as_dict() for c in checks]})
        violations.extend({"phase": spec.name, **c.as_dict()}
                          for c in checks if not c.ok)
    run_checks: List[Check] = []
    if scenario.compile_flat:
        known = (compiles_after_warmup is not None
                 and compiles_at_end is not None)
        delta = (compiles_at_end - compiles_after_warmup) if known else None
        run_checks.append(Check("slo.compile.flat", 0, delta,
                                known and delta == 0))

    def _growth(field):
        a = (usage_after_warmup or {}).get(field)
        b = (usage_at_end or {}).get(field)
        return (b - a) if (a is not None and b is not None) else None

    if scenario.fd_growth_max is not None:
        d = _growth("fds")
        run_checks.append(Check("slo.fd.growth.max",
                                scenario.fd_growth_max, d,
                                d is not None
                                and d <= scenario.fd_growth_max))
    if scenario.rss_growth_max_mb is not None:
        d = _growth("rss_mb")
        run_checks.append(Check(
            "slo.rss.growth.max.mb", scenario.rss_growth_max_mb,
            round(d, 2) if d is not None else None,
            d is not None and d <= scenario.rss_growth_max_mb))
    if scenario.soak_cycles_min is not None:
        known = (cycles_after_warmup is not None
                 and cycles_at_end is not None)
        d = (cycles_at_end - cycles_after_warmup) if known else None
        # a FLOOR, not a ceiling: the run must have driven at least
        # this many promote/demote cycles for its flatness gates to
        # have judged real churn
        run_checks.append(Check("soak.cycles.min",
                                scenario.soak_cycles_min, d,
                                known and d >= scenario.soak_cycles_min))
    violations.extend({"phase": "__run__", **c.as_dict()}
                      for c in run_checks if not c.ok)
    return {
        "v": VERDICT_VERSION,
        "scenario": scenario.name,
        "seed": scenario.seed,
        "target": scenario.target,
        "threads": scenario.threads,
        "pass": not violations,
        "phases": phases,
        "run_checks": [c.as_dict() for c in run_checks],
        "violations": violations,
        "compiles": {"after_warmup": compiles_after_warmup,
                     "at_end": compiles_at_end},
        "resources": {"after_warmup": usage_after_warmup,
                      "at_end": usage_at_end,
                      "cycles_after_warmup": cycles_after_warmup,
                      "cycles_at_end": cycles_at_end},
    }


def write_verdict(path: str, verdict: dict) -> None:
    """Atomic publish (core.io): readers never see a torn verdict."""
    atomic_write_text(path, json.dumps(verdict, indent=2) + "\n")


def dump_violation(scenario: Scenario, verdict: dict,
                   per_phase: Dict[str, PhaseStats],
                   phase_snapshot: Optional[dict]) -> Optional[str]:
    """Exactly one ``flight-workload-<scenario>`` black-box dump for a
    failed ``--assert``: the first violating phase's summary + checks,
    its merged telemetry snapshot, and the worst-offender exemplar.
    ``force=True`` bypasses the recorder's rate limit — an operator
    asked this run to assert, so the dump must exist."""
    if verdict["pass"]:
        return None
    first = verdict["violations"][0]
    phase = first["phase"]
    stats = per_phase.get(phase)
    worst = None
    if stats is not None and stats.worst is not None:
        worst = {"latency_ms": round(stats.worst[0], 3),
                 "trace_id": stats.worst[1], "kind": stats.worst[2],
                 "tenant": stats.worst[3]}
    return flight.trigger(
        f"workload-{scenario.name}", force=True,
        trace_id=(worst or {}).get("trace_id"),
        phase=phase,
        violations=verdict["violations"],
        phase_summary=(stats.summary() if stats is not None else None),
        phase_snapshot=phase_snapshot,
        worst_offender=worst)
