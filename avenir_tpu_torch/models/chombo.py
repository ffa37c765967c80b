"""External chombo MR jobs that reference pipelines invoke between avenir
jobs: the port's copy of ``avenir_tpu/models/chombo.py``.  chombo is the sister utility library (SURVEY §2.0: declared
``mawazo:chombo:1.0`` pom dependency, source NOT vendored in the reference
repo), so these semantics are reconstructed from every call site in the
reference runbooks/properties — each job cites the exact lines it serves.

These are host-side data-wrangling legs (filter / reorder / running
aggregate) between the device-bound avenir jobs; none of them is a
counting or FLOPs workload, so they run as plain streaming host passes —
the device work stays with the jobs around them.

- ``org.chombo.mr.TemporalFilter`` — the Apriori pipeline's time-range
  filter (resource/fit.sh:30-41, tef.* keys in resource/fit.properties:8-14).
- ``org.chombo.mr.Projection`` — the Markov tutorials' group-and-order
  projection (cust_churn_markov_chain_classifier_tutorial.txt:26-37,83-90;
  projection.* keys in resource/buyhist.properties:6-11).
- ``org.chombo.mr.RunningAggregator`` — the bandit round loop's reward
  re-aggregation (price_optimize_tutorial.txt:41-62; quantity.attr /
  incremental.file.prefix keys in the tutorial's Configuration section),
  whose math is ``models.bandit.aggregate_rewards``.

Each job takes a ``device`` like the port's other jobs and resolves it
(so no entry point quietly runs on the CPU), though none of them does
device work.
"""

from __future__ import annotations

import os
from typing import List

from ..core.config import JobConfig
from ..core.obs import traced_run
from ..core.io import _input_files, read_lines, split_line, write_output
from ..core.metrics import Counters
from ..device import resolve_device
from .bandit import aggregate_rewards


class TemporalFilter:
    """Map-only epoch-time-range row filter (resource/fit.sh:30-41).

    Config (resource/fit.properties:8-14): ``time.stamp.field.ordinal``,
    ``time.range`` = comma-separated ``start:end`` windows (inclusive),
    ``time.stamp.in.mili`` (divide by 1000 first),
    ``time.zone.shift.hours`` (added before the compare), and
    ``seasonal.cycle.type``.  The reference pipeline uses
    ``anyTimeRange`` (windows in raw epoch seconds); the other chombo
    SeasonalAnalyzer cycle types interpret the windows as positions
    WITHIN the cycle — chombo's source is not vendored in the reference
    repo (SURVEY §2.0), so the cycle index definitions below are
    reconstructed and documented here: ``quarterHourOfDay`` 0-95,
    ``halfHourOfDay`` 0-47, ``hourOfDay`` 0-23 (all straight epoch
    divisions), ``dayOfWeek`` 0-6 with 0 = Sunday (Java
    Calendar.DAY_OF_WEEK order minus one), ``weekDayOrWeekEnd`` 0 =
    weekday / 1 = weekend, ``monthOfYear`` 0-11 (UTC).  Unknown types
    still fail fast.  Rows inside any window pass through unchanged.

    DOCUMENTED DIVERGENCE (timezone semantics, ADVICE r5): every cycle
    index here is computed in UTC plus the FIXED ``time.zone.shift.hours``
    offset, whereas chombo's SeasonalAnalyzer goes through
    ``java.util.Calendar`` in the JVM's DEFAULT timezone.  For non-UTC
    deployments the day/week/month boundaries can differ — in particular
    a DST transition moves Calendar-local boundaries by an hour twice a
    year, which no fixed shift can express (a row stamped inside the DST
    gap lands in the previous ``dayOfWeek``/``monthOfYear`` cell here).
    Operators needing Calendar-local parity must run with a UTC JVM
    default on the reference side or pre-shift timestamps; re-verify
    against chombo upstream if its source becomes available.
    """

    CYCLES = ("anyTimeRange", "quarterHourOfDay", "halfHourOfDay",
              "hourOfDay", "dayOfWeek", "weekDayOrWeekEnd", "monthOfYear")

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @staticmethod
    def _cycle_index(cycle: str, t: int) -> int:
        if cycle == "anyTimeRange":
            return t
        if cycle == "quarterHourOfDay":
            return (t // 900) % 96
        if cycle == "halfHourOfDay":
            return (t // 1800) % 48
        if cycle == "hourOfDay":
            return (t // 3600) % 24
        if cycle == "dayOfWeek":
            # epoch day 0 (1970-01-01) was a Thursday; 0 = Sunday per
            # Java Calendar.DAY_OF_WEEK - 1
            return ((t // 86400) + 4) % 7
        if cycle == "weekDayOrWeekEnd":
            return 1 if ((t // 86400) + 4) % 7 in (0, 6) else 0
        if cycle == "monthOfYear":
            import time as _time
            return _time.gmtime(t).tm_mon - 1
        raise AssertionError(cycle)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        cfg = self.config
        counters = Counters()
        cycle = cfg.get("seasonal.cycle.type", "anyTimeRange")
        if cycle not in self.CYCLES:
            raise ValueError(
                f"seasonal.cycle.type {cycle!r} not supported; known "
                f"types: {', '.join(self.CYCLES)}")
        ts_ord = cfg.must_int("time.stamp.field.ordinal")
        in_mili = cfg.get_boolean("time.stamp.in.mili", False)
        shift = 3600 * (cfg.get_int("time.zone.shift.hours", 0) or 0)
        ranges = []
        for spec in (cfg.get("time.range") or "").split(","):
            lo, _, hi = spec.partition(":")
            if not hi:
                raise ValueError(f"bad time.range window {spec!r}; "
                                 "expected start:end (epoch seconds for "
                                 "anyTimeRange, cycle positions "
                                 "otherwise)")
            ranges.append((int(lo), int(hi)))
        delim_regex = cfg.field_delim_regex()

        out: List[str] = []
        for line in read_lines(in_path):
            counters.incr("Basic", "Records read")
            t = int(split_line(line, delim_regex)[ts_ord])
            if in_mili:
                t //= 1000
            t += shift
            idx = self._cycle_index(cycle, t)
            if any(lo <= idx <= hi for lo, hi in ranges):
                out.append(line)
                counters.incr("Basic", "Records emitted")
        write_output(out_path, out)
        return counters


class Projection:
    """Column projection with optional group-and-order
    (cust_churn_markov_chain_classifier_tutorial.txt:26-37).

    Config (resource/buyhist.properties:6-11): ``projection.operation``
    ``project`` (plain column projection) or ``groupingOrdering`` (group
    rows by ``key.field`` ordinals, order each group by
    ``orderBy.field`` — numeric when every value parses as a number,
    else lexicographic, which orders ISO dates correctly — then emit the
    ``projection.field`` columns).  ``format.compact=true`` emits one
    line per key (key fields, then each record's projected fields in
    order — the tutorial's "one output line per customer"); otherwise
    one line per record (key fields + projected fields), groups
    contiguous.  Sorting is stable, matching the secondary-sort tie
    behavior of a single-reducer chombo run.
    """

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        cfg = self.config
        counters = Counters()
        op = cfg.get("projection.operation", "project")
        proj = [int(f) for f in cfg.get_list("projection.field") or []]
        if not proj:
            raise ValueError("projection.field is required")
        delim_regex = cfg.field_delim_regex()
        delim = cfg.field_delim_out()

        if op == "project":
            out = []
            for line in read_lines(in_path):
                counters.incr("Basic", "Records read")
                items = split_line(line, delim_regex)
                out.append(delim.join(items[f] for f in proj))
            write_output(out_path, out)
            return counters
        if op != "groupingOrdering":
            raise ValueError(f"unknown projection.operation {op!r}; "
                             "use 'project' or 'groupingOrdering'")

        key_ords = [int(f) for f in cfg.get_list("key.field") or []]
        if not key_ords:
            raise ValueError("key.field is required for groupingOrdering")
        order_ord = cfg.must_int("orderBy.field")
        compact = cfg.get_boolean("format.compact", False)

        groups: dict = {}
        for line in read_lines(in_path):
            counters.incr("Basic", "Records read")
            items = split_line(line, delim_regex)
            key = tuple(items[f] for f in key_ords)
            groups.setdefault(key, []).append(items)

        out = []
        # reducer key-sorted group order, as a single-reducer chombo MR
        # would emit (keys are text tuples, so lexicographic)
        for key, recs in sorted(groups.items()):
            # numeric order only when the whole group's orderBy column
            # parses (the documented column-level rule); else
            # lexicographic — which orders ISO dates correctly
            try:
                order_key = [(float(r[order_ord]), i)
                             for i, r in enumerate(recs)]
                if any(v != v for v, _ in order_key):   # NaN literals
                    raise ValueError
            except ValueError:
                order_key = [(r[order_ord], i) for i, r in enumerate(recs)]
            recs = [recs[i] for _, i in sorted(order_key)]
            if compact:
                fields = list(key)
                for items in recs:
                    fields.extend(items[f] for f in proj)
                out.append(delim.join(fields))
            else:
                for items in recs:
                    out.append(delim.join(
                        list(key) + [items[f] for f in proj]))
        counters.set("Basic", "Groups", len(groups))
        write_output(out_path, out)
        return counters


class RunningAggregator:
    """Inter-round running-average aggregation
    (price_optimize_tutorial.txt:41-62): the input dir holds the previous
    running-aggregate state (``group,item,count,avg`` — the bandit jobs'
    input format) plus incremental reward files whose basenames start
    with ``incremental.file.prefix`` (``group,item,...,reward`` with the
    reward at ``quantity.attr``); the output is the updated state the
    next round's bandit job reads.  The math is
    ``models.bandit.aggregate_rewards`` (integer running average, Java
    long-division parity) — this job is its CLI packaging, completing
    the tutorial's literal run-job/score/re-aggregate/bump-round loop.
    """

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        cfg = self.config
        counters = Counters()
        qty_ord = cfg.get_int("quantity.attr", 2)
        prefix = cfg.get("incremental.file.prefix", "inc")
        delim_regex = cfg.field_delim_regex()
        delim = cfg.field_delim_out()

        prev: List[str] = []
        incr: List[str] = []
        for path in _input_files(in_path):
            incremental = os.path.basename(path).startswith(prefix)
            for line in read_lines(path):
                items = split_line(line, delim_regex)
                if incremental:
                    counters.incr("Basic", "Incremental records")
                    incr.append(delim.join(
                        items[:2] + [items[qty_ord]]))
                else:
                    counters.incr("Basic", "State records")
                    prev.append(delim.join(items[:4]))

        out = aggregate_rewards(incr, prev, delim=delim)
        counters.set("Basic", "State records out", len(out))
        write_output(out_path, out)
        return counters
