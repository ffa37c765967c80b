"""Sliding-window event-locality analysis + criteria expressions (the
port's copy of ``avenir_tpu/core/window.py``) — the
hoidla-equivalent surface (SURVEY §2.0: hoidla is an external pom dependency,
not vendored; its window/criteria classes are implicit spec consumed by
``sequence.SequencePositionalCluster``).

Reference usage (citations into the reference's Java sources):
- ``TimeBoundEventLocalityAnalyzer(windowTimeSpan, timeStep, strategyContext)``
  fed ``ExplicitlyTimetStampedValue(value, timestamp, conditionMet)`` items,
  queried with ``getScore()`` (sequence/SequencePositionalCluster.java:91-160).
- ``EventLocality.Context`` built either from a ``strategy -> weight`` map
  (``weighted.strategies``) or from (minOccurence, maxIntervalAverage,
  maxIntervalMax, preferredStrategies) (:113-132).
- ``Criteria.createCriteriaFromExpression(condExpression)`` +
  ``evaluate(operandValues)`` over ``$<i>`` operands (:136-138, 163-165).

hoidla's exact scoring internals are not part of this repo, so the scores
here are a documented design: each strategy yields a locality score in
[0, 1] over the CONDITION-MEETING events inside the time window —

- ``count``: ``min(1, occurrences / minOccurence)`` — more qualifying events
  in the window = more clustered.
- ``averageInterval``: ``min(1, maxIntervalAverage / avgInterval)`` — smaller
  mean gap between qualifying events = more clustered.
- ``maxInterval``: ``min(1, maxIntervalMax / maxInterval)`` — no large gap
  splitting the cluster.

Unweighted contexts take the max over the preferred strategies; weighted
contexts take the weight-normalized sum.  Single qualifying events score 0
under interval strategies (no interval exists).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class TimeStampedValue:
    """hoidla ExplicitlyTimetStampedValue: (value, timestamp, conditionMet)."""
    value: float
    timestamp: int
    condition_met: bool = False


class EventLocalityContext:
    """Strategy configuration (hoidla EventLocality.Context)."""

    STRATEGIES = ("count", "averageInterval", "maxInterval")

    def __init__(self,
                 weighted_strategies: Optional[Dict[str, float]] = None,
                 min_occurence: int = 1,
                 max_interval_average: int = 1,
                 max_interval_max: int = 1,
                 preferred_strategies: Optional[Sequence[str]] = None):
        self.weighted_strategies = weighted_strategies
        self.min_occurence = min_occurence
        self.max_interval_average = max_interval_average
        self.max_interval_max = max_interval_max
        self.preferred_strategies = list(preferred_strategies or [])
        names = (list(weighted_strategies) if weighted_strategies
                 else self.preferred_strategies)
        for s in names:
            if s not in self.STRATEGIES:
                raise ValueError(f"unknown event-locality strategy: {s}")

    def _strategy_score(self, strategy: str, stamps: List[int]) -> float:
        n = len(stamps)
        if strategy == "count":
            return min(1.0, n / self.min_occurence)
        if n < 2:
            return 0.0
        intervals = [b - a for a, b in zip(stamps, stamps[1:])]
        if strategy == "averageInterval":
            avg = sum(intervals) / len(intervals)
            return 1.0 if avg <= 0 else min(1.0, self.max_interval_average / avg)
        if strategy == "maxInterval":
            mx = max(intervals)
            return 1.0 if mx <= 0 else min(1.0, self.max_interval_max / mx)
        raise ValueError(strategy)

    def score(self, stamps: List[int]) -> float:
        if not stamps:
            return 0.0
        if self.weighted_strategies:
            total_w = sum(self.weighted_strategies.values())
            return sum(w * self._strategy_score(s, stamps)
                       for s, w in self.weighted_strategies.items()) / total_w
        if not self.preferred_strategies:
            return 0.0
        return max(self._strategy_score(s, stamps)
                   for s in self.preferred_strategies)


class TimeBoundEventLocalityAnalyzer:
    """Time-span-bound sliding window scoring the positions of
    condition-meeting events (hoidla TimeBoundEventLocalityAnalyzer)."""

    def __init__(self, window_time_span: int, time_step: int,
                 context: EventLocalityContext):
        self.window_time_span = window_time_span
        self.time_step = time_step
        self.context = context
        self.events: List[TimeStampedValue] = []
        self._score = 0.0
        self._last_processed: Optional[int] = None

    def add(self, item: TimeStampedValue) -> None:
        self.events.append(item)
        # evict everything older than the span behind the newest stamp
        horizon = item.timestamp - self.window_time_span
        self.events = [e for e in self.events if e.timestamp > horizon]
        # re-score every processing time step
        if (self._last_processed is None
                or item.timestamp - self._last_processed >= self.time_step):
            stamps = sorted(e.timestamp for e in self.events if e.condition_met)
            self._score = self.context.score(stamps)
            self._last_processed = item.timestamp

    def get_score(self) -> float:
        return self._score


# ---------------------------------------------------------------------------
# criteria expressions (hoidla Predicate/Criteria)
# ---------------------------------------------------------------------------

_COMPARISON = re.compile(
    r"^\s*\$(\d+)\s*(<=|>=|==|!=|<|>)\s*(-?\d+(?:\.\d+)?)\s*$")

_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


class Criteria:
    """Boolean combination of ``$<ordinal> <op> <literal>`` comparisons over
    an operand array, e.g. ``"$0 > 100 && $0 <= 500"``.  Supports ``&&`` /
    ``||`` (no parentheses — && binds tighter, matching common expression
    semantics)."""

    def __init__(self, or_groups: List[List[Tuple[int, str, float]]],
                 num_predicates: int):
        self._or_groups = or_groups
        self.num_predicates = num_predicates

    @classmethod
    def create_criteria_from_expression(cls, expression: str) -> "Criteria":
        or_groups = []
        count = 0
        for disjunct in expression.split("||"):
            group = []
            for conjunct in disjunct.split("&&"):
                m = _COMPARISON.match(conjunct)
                if not m:
                    raise ValueError(
                        f"bad criteria predicate: {conjunct.strip()!r} "
                        "(expected '$<ordinal> <op> <number>')")
                group.append((int(m.group(1)), m.group(2), float(m.group(3))))
                count += 1
            or_groups.append(group)
        return cls(or_groups, count)

    def get_num_predicates(self) -> int:
        return self.num_predicates

    def evaluate(self, operand_values: Sequence[float]) -> bool:
        return any(
            all(_OPS[op](operand_values[ordinal], literal)
                for ordinal, op, literal in group)
            for group in self._or_groups)
