"""Seeded workload-generator primitives: the scenario factory's L0.

The reference avenir repo shipped a family of synthetic-data generators
(``resource/*.py``) whose whole value was *controlled shape*: you knew
exactly what distribution went in, so you could judge what came out.
This module is the serving-side descendant — instead of training rows it
produces **production-shaped traffic**: open-loop arrival processes
(constant, Poisson, diurnal sinusoid, flash-crowd step), Zipf tenant
popularity (a small hot set carrying most of the traffic — the regime
the managed model cache exists for), heavy-tailed payload sizes, poison
row storms, and feedback dup/reorder/lag chaos for the bandit stream.

Every primitive draws ONLY from the :class:`random.Random` instance it
is handed, so a scenario's full event schedule is a pure function of its
manifest seed: two builds of the same manifest are byte-identical
(asserted by :func:`schedule_bytes` in tests/test_workload.py), which is
what turns "flat p99 through a surge" into a regression test instead of
an anecdote.

Arrival processes are generated by inverting the cumulative rate
function Λ(t) (``Λ(t) = k`` gives the k-th arrival), so the *offered*
schedule is independent of how fast the system under test answers —
the open-loop property that makes queueing measurable (coordinated
omission is a closed-loop artifact; see BASELINE.md).
"""

from __future__ import annotations

import bisect
import json
import math
import random
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Event", "arrival_offsets", "zipf_weights", "hot_share",
    "ZipfSampler", "payload_rows", "churn_row", "poison_row",
    "schedule_bytes", "partition",
]


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

class Event:
    """One scheduled wire operation: a predict/decide request or a
    feedback publish, stamped with its *intended* start offset inside
    its phase.  The driver measures latency from this intended start —
    never from the actual send time — so a backlog shows up in the
    percentiles instead of silently stretching the schedule."""

    __slots__ = ("phase", "offset_s", "kind", "tenant", "rows", "poison",
                 "fault")

    #: wire kinds: "predict" sends {"model","rows"}; "decide" sends the
    #: streaming alias {"decide": "eventId,tenant"}; "feedback" sends
    #: {"cmd":"feedback","event":"tenant,arm,reward"}
    KINDS = ("predict", "decide", "feedback")

    def __init__(self, phase: str, offset_s: float, kind: str, tenant: str,
                 rows: List[str], poison: bool = False, fault: str = ""):
        self.phase = phase
        self.offset_s = float(offset_s)
        self.kind = kind
        self.tenant = tenant
        self.rows = rows
        self.poison = bool(poison)
        self.fault = fault

    def as_dict(self) -> dict:
        return {"phase": self.phase, "offset_s": round(self.offset_s, 9),
                "kind": self.kind, "tenant": self.tenant, "rows": self.rows,
                "poison": self.poison, "fault": self.fault}

    def __repr__(self) -> str:      # pragma: no cover - debugging aid
        return (f"Event({self.phase!r}, {self.offset_s:.4f}, {self.kind!r}, "
                f"{self.tenant!r}, rows={len(self.rows)}, "
                f"poison={self.poison}, fault={self.fault!r})")


def schedule_bytes(events: Iterable[Event]) -> bytes:
    """The canonical byte form of a schedule: one sorted-key JSON object
    per line.  The deterministic-replay gate compares THESE bytes — any
    hidden dependence on thread count, wall clock, or dict order fails
    loudly."""
    return "".join(
        json.dumps(e.as_dict(), sort_keys=True) + "\n"
        for e in events).encode()


def partition(events: Sequence[Event], threads: int) -> List[List[Event]]:
    """Deterministic round-robin split of a time-sorted schedule across
    ``threads`` client workers.  Slicing (``events[k::threads]``) keeps
    every worker's slice time-sorted and makes the union trivially
    independent of the worker count — the property the replay test
    asserts at two thread counts."""
    n = max(int(threads), 1)
    return [list(events[k::n]) for k in range(n)]


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

def _piecewise_constant(segments: Sequence[tuple]) -> List[float]:
    """Invert Λ(t) for piecewise-constant rates: ``segments`` is
    ``(t_start, t_end, rate)`` tuples; arrival k lands where the
    cumulative expected count crosses k."""
    out: List[float] = []
    cum = 0.0
    for t0, t1, rate in segments:
        if rate <= 0 or t1 <= t0:
            cum += max(rate, 0.0) * max(t1 - t0, 0.0)
            continue
        k = math.floor(cum) + 1
        while True:
            t = t0 + (k - cum) / rate
            if t >= t1:
                break
            out.append(t)
            k += 1
        cum += rate * (t1 - t0)
    return out


def _diurnal_offsets(rate: float, duration_s: float, period_s: float,
                     amplitude: float) -> List[float]:
    """Invert the sinusoid's closed-form cumulative rate
    ``Λ(t) = r·t + r·A·P/2π · (1 − cos(2πt/P))`` by bisection per
    arrival — exact (to float tolerance) and allocation-free of any
    clock or rng, so replays are bit-stable."""
    amp = min(max(amplitude, 0.0), 1.0)
    two_pi = 2.0 * math.pi

    def cum(t: float) -> float:
        return rate * (t + amp * period_s / two_pi
                       * (1.0 - math.cos(two_pi * t / period_s)))

    total = cum(duration_s)
    out: List[float] = []
    k = 1
    while k <= total:
        lo, hi = 0.0, duration_s
        for _ in range(60):
            mid = (lo + hi) / 2.0
            if cum(mid) < k:
                lo = mid
            else:
                hi = mid
        out.append((lo + hi) / 2.0)
        k += 1
    return out


def arrival_offsets(mode: str, rate: float, duration_s: float,
                    rng: random.Random, *,
                    surge_factor: float = 10.0,
                    surge_start_s: Optional[float] = None,
                    surge_duration_s: Optional[float] = None,
                    period_s: Optional[float] = None,
                    amplitude: float = 0.5) -> List[float]:
    """One phase's intended arrival offsets (seconds from phase start),
    sorted ascending, all < ``duration_s``.

    Modes: ``constant`` (even spacing at ``rate``), ``poisson``
    (exponential gaps from ``rng``), ``flash`` (constant with a
    ``surge_factor``× step inside ``[surge_start_s, surge_start_s +
    surge_duration_s)`` — the flash-crowd shape INFaaS evaluates
    autoscalers with), ``diurnal`` (rate modulated by ``1 + amplitude ·
    sin(2πt/period_s)`` — a compressed day)."""
    if rate <= 0 or duration_s <= 0:
        return []
    if mode == "constant":
        return _piecewise_constant([(0.0, duration_s, rate)])
    if mode == "poisson":
        out: List[float] = []
        t = rng.expovariate(rate)
        while t < duration_s:
            out.append(t)
            t += rng.expovariate(rate)
        return out
    if mode == "flash":
        ss = duration_s / 3.0 if surge_start_s is None else surge_start_s
        sd = (duration_s / 3.0 if surge_duration_s is None
              else surge_duration_s)
        ss = min(max(ss, 0.0), duration_s)
        se = min(ss + max(sd, 0.0), duration_s)
        return _piecewise_constant([
            (0.0, ss, rate),
            (ss, se, rate * max(surge_factor, 0.0)),
            (se, duration_s, rate)])
    if mode == "diurnal":
        period = duration_s if period_s is None else period_s
        return _diurnal_offsets(rate, duration_s, period, amplitude)
    raise ValueError(
        f"unknown arrival mode {mode!r} (constant|poisson|flash|diurnal)")


# ---------------------------------------------------------------------------
# tenant popularity
# ---------------------------------------------------------------------------

def zipf_weights(n: int, exponent: float) -> List[float]:
    """Normalized Zipf popularity over ``n`` ranked tenants: weight of
    rank r ∝ 1/r^exponent.  At the scenario default (1,000 tenants,
    exponent 1.5) the top 20 tenants carry ~85% of the traffic — the
    hot-set/long-tail regime the model cache and promote quotas
    were built for."""
    if n < 1:
        raise ValueError(f"need at least one tenant, got {n}")
    w = [1.0 / (r ** exponent) for r in range(1, n + 1)]
    total = sum(w)
    return [x / total for x in w]


def hot_share(weights: Sequence[float], k: int) -> float:
    """The traffic fraction the top ``k`` ranks carry (weights are
    already rank-sorted by construction)."""
    return sum(weights[:max(k, 0)])


class ZipfSampler:
    """Draw ranked tenant indices under a Zipf popularity law using only
    the supplied rng (bisect over the cumulative weights — O(log n) per
    draw, no numpy, no global state)."""

    def __init__(self, n: int, exponent: float):
        self.weights = zipf_weights(n, exponent)
        self._cum: List[float] = []
        acc = 0.0
        for w in self.weights:
            acc += w
            self._cum.append(acc)
        self._cum[-1] = 1.0     # guard float drift at the top rank

    def draw(self, rng: random.Random) -> int:
        return bisect.bisect_left(self._cum, rng.random())


# ---------------------------------------------------------------------------
# payload mix
# ---------------------------------------------------------------------------

def payload_rows(rng: random.Random, median: int, sigma: float,
                 cap: int) -> int:
    """One request's row count from a log-normal (heavy-tailed) size
    mix: most requests are small, a fat tail batches hundreds of rows —
    the mix that actually exercises the micro-batcher's coalescing and
    padding paths instead of a fixed-size sweep."""
    n = int(round(math.exp(rng.normalvariate(math.log(max(median, 1)),
                                             max(sigma, 0.0)))))
    return min(max(n, 1), max(cap, 1))


# ---------------------------------------------------------------------------
# row content
# ---------------------------------------------------------------------------

_PLANS = ("planA", "planB")


def churn_row(rng: random.Random, ident: int) -> str:
    """One well-formed telecom-churn row matching the bootstrap schema
    the harness trains its Naive Bayes artifact against (same field
    extents as ``resource/serving/teleComChurn.json``)."""
    return ",".join((
        f"w{ident:08d}",
        _PLANS[rng.randrange(2)],
        str(rng.randrange(0, 2200)),
        str(rng.randrange(0, 1000)),
        str(rng.randrange(0, 14)),
        str(rng.randrange(0, 22)),
        str(rng.randrange(1, 5)),
        "NY"[rng.randrange(2)],
    ))


#: the content marker the poison-storm fault plan keys on
#: (``fault.inject.plan=scorer_poison@*x100000:POISON`` — the repo's
#: chaos-soak idiom for making the scorer RAISE on specific rows)
POISON_MARKER = "POISON"


def poison_row(rng: random.Random, ident: int) -> str:
    """One poison row for the storm path: a perfectly VALID churn row
    whose id carries :data:`POISON_MARKER`.  It passes admission and
    batching like any other request; the scenario's content-based
    ``scorer_poison`` fault plan then fails any scorer batch holding it,
    forcing the serve tier's bisect isolation to quarantine this
    row with a structured ``poison`` response while cohabiting requests
    in the same micro-batch score normally.  (A merely-garbage row would
    be rejected upstream as "Unscorable" and never reach the isolation
    path at all.)"""
    return ",".join((
        f"{POISON_MARKER}-{ident:08d}",
        _PLANS[rng.randrange(2)],
        str(rng.randrange(0, 2200)),
        str(rng.randrange(0, 1000)),
        str(rng.randrange(0, 14)),
        str(rng.randrange(0, 22)),
        str(rng.randrange(1, 5)),
        "NY"[rng.randrange(2)],
    ))


# ---------------------------------------------------------------------------
# feedback chaos tags
# ---------------------------------------------------------------------------

def feedback_fault(rng: random.Random, dup_fraction: float,
                   reorder_fraction: float) -> str:
    """Classify one feedback publish: ``dup`` (send the same event
    twice — the exactly-once fold must count it once), ``reorder``
    (swap with its neighbor's offset), or clean.  Lag is applied as a
    schedule offset, not a tag."""
    r = rng.random()
    if r < dup_fraction:
        return "dup"
    if r < dup_fraction + reorder_fraction:
        return "reorder"
    return ""
