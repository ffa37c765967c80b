"""Sequential-pattern mining support jobs: the port's copy of
``avenir_tpu/models/sequence.py``, host code in both packages.  Each job
takes a ``device`` and resolves it, as the port's other jobs do, though
neither does device work.

Reference surface being re-expressed (citations into the reference's Java sources):
- ``org.avenir.sequence.CandidateGenerationWithSelfJoin`` — GSP candidate
  generation: joins every pair of frequent k-sequences where
  ``a[1:] == b[:-1]`` into the (k+1)-candidate ``a + b[-1]``; the all-same-
  token self-join emits ``seq + token``
  (sequence/CandidateGenerationWithSelfJoin.java:217-276).  The reference
  distributes this as a bucketed hash self-join — each sequence is hashed to
  one of ``cgs.bucket.count`` buckets and replicated to every bucket-pair
  reducer (:116-144).  That machinery exists only because no single reducer
  could hold the full candidate set; frequent-sequence lists are small
  (they fit in one mapper's side file in the Apriori family), so here the
  join is an in-memory hash join on the (k-1)-prefix — O(n·k) instead of the
  reducer-pair O(n²/buckets) — with identical output semantics.
- ``org.avenir.sequence.SequencePositionalCluster`` — map-only temporal
  clustering: each record carries (seqNum/timestamp, quantValue); records
  matching a criteria expression enter a time-bound window; when the window's
  event-locality score exceeds ``score.threshold``, emit
  ``seqNum,quantValue,score`` (sequence/SequencePositionalCluster.java:80-166).
  The hoidla window/criteria classes it uses are re-expressed in
  ``core.window``.

Deliberate divergence: the reference's reverse-direction join appends
``thatSeq[k-1]`` instead of ``thisSeq[k-1]``
(CandidateGenerationWithSelfJoin.java:268-272), producing a candidate whose
tail repeats an element of ``thatSeq`` — with the hash join both directions
of every ordered pair are generated by the SAME forward rule, so the broken
branch has no equivalent here; standard GSP output is produced.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.config import JobConfig
from ..core.obs import traced_run
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..device import resolve_device
from ..core.window import (Criteria, EventLocalityContext,
                           TimeBoundEventLocalityAnalyzer, TimeStampedValue)


def gsp_candidates(sequences: List[Tuple[str, ...]]) -> List[Tuple[str, ...]]:
    """All (k+1)-candidates from frequent k-sequences: for ordered pair
    (a, b) with a[1:] == b[:-1], emit a + (b[-1],); deduplicated, first-seen
    order.  Includes the all-same-token self join (a==b case of the rule)."""
    by_prefix: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
    for s in sequences:
        by_prefix.setdefault(s[:-1], []).append(s)
    seen = set()
    out: List[Tuple[str, ...]] = []
    for a in sequences:
        for b in by_prefix.get(a[1:], ()):
            cand = a + (b[-1],)
            if cand not in seen:
                seen.add(cand)
                out.append(cand)
    return out


class CandidateGenerationWithSelfJoin:
    """GSP candidate-generation job (config prefix ``cgs.*``)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        k = cfg.must_int("item.set.length", "missing item set length")
        delim = cfg.field_delim_out()

        sequences = []
        for line in read_lines(in_path):
            items = split_line(line, cfg.field_delim_regex())
            sequences.append(tuple(items[:k]))

        out = [delim.join(c) for c in gsp_candidates(sequences)]
        write_output(out_path, out)
        counters.set("Candidates", "Generated", len(out))
        return counters


class SequencePositionalCluster:
    """Positional temporal clustering job (map-only)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    def _build_window(self) -> TimeBoundEventLocalityAnalyzer:
        cfg = self.config
        span = cfg.must_int("window.time.span", "wondow time span must be specified")
        step = cfg.must_int("processing.time.step", "missing window processing time step")
        if cfg.get_boolean("weighted.strategy",
                           cfg.get_boolean("wejghter.strategy", False)):
            # "strategy:weight,strategy:weight" (SequencePositionalCluster.java:118)
            raw = cfg.must("weighted.strategies")
            weights = {}
            for part in raw.split(","):
                name, w = part.split(":")
                weights[name] = float(w)
            ctx = EventLocalityContext(weighted_strategies=weights)
        else:
            ctx = EventLocalityContext(
                min_occurence=cfg.must_int("min.occurence"),
                max_interval_average=cfg.must_int("max.interval.average"),
                max_interval_max=cfg.must_int("max.interval.max"),
                preferred_strategies=cfg.must_list("preferred.strategies"))
        return TimeBoundEventLocalityAnalyzer(span, step, ctx)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        quant_ord = cfg.must_int("quant.field.ordinal", "missing quantity field ordinal")
        # the reference's key has a double dot (SequencePositionalCluster.java:111)
        seq_ord = cfg.get_int("seq.num.field.ordinal",
                              cfg.get_int("seq.num..field.ordinal", None))
        if seq_ord is None:
            raise ValueError("missing sequence field ordinal")
        threshold = cfg.must_float("score.threshold", "missing score threhold parameter")
        criteria = Criteria.create_criteria_from_expression(
            cfg.must("cond.expression", "mission conditional expression"))
        window = self._build_window()

        out = []
        for line in read_lines(in_path):
            items = split_line(line, cfg.field_delim_regex())
            quant = float(items[quant_ord])
            stamp = int(items[seq_ord])
            operands = [quant] * criteria.get_num_predicates()
            window.add(TimeStampedValue(quant, stamp,
                                        criteria.evaluate(operands)))
            score = window.get_score()
            if score > threshold:
                out.append(f"{items[seq_ord]}{delim}{items[quant_ord]}"
                           f"{delim}{score}")
                counters.incr("Cluster", "Emitted")
        write_output(out_path, out)
        return counters
