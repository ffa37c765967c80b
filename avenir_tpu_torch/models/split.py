"""Split enumeration, predicates, and split-quality statistics for the tree
family: the port's copy of ``avenir_tpu/models/split.py`` (jax-free, so
copied as it is; reference: tree/SplitManager.java,
util/AttributeSplitHandler.java, util/AttributeSplitStat.java,
util/InfoContentStat.java).

Everything here is host-side model logic: candidate-split lists are tiny
(bounded by maxSplit <= 3 and the scan interval), so enumeration stays in
Python exactly as the reference keeps it in task-local JVM memory
(SURVEY §7.3 hard part: the combinatorial categorical set-partition
enumeration stays host-side).  The per-record/per-predicate evaluation that
the reference does in mapper hot loops (DecisionTreeBuilder.java:275-320) is
vectorized in ``predicate_matrix`` / ``segment_index`` over whole columns;
the (path, predicate, class) counting those feed runs on device
(models/tree.py).

Reference-parity notes (deliberate reproductions / documented deviations):
- SplitManager.createIntAttrPredicates (SplitManager.java:551-578) gives the
  LAST split point an *unbounded* ``le`` predicate (the ``i == len-1`` branch
  skips the lower bound), so multi-point splits have overlapping predicates.
  ``segment_predicates`` reproduces this faithfully — DecisionTreeBuilder
  counts per predicate, so the overlap is observable in its output.
- DoublePredicate's two-bound constructor never assigns ``otherBound``
  (SplitManager.java:749-752), so double predicates evaluate AND print
  unbounded.  Reproduced.
- The reference joins integer split keys with ";" when emitting
  (AttributeSplitHandler.java:44) but parses them with ":"
  (AttributeSplitHandler.java:160, DataPartitioner's getSegmentCount).  We
  standardize on ":" — the only self-consistent choice — and note it here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.schema import FeatureField, FeatureSchema

OPERATOR_LE = "le"
OPERATOR_GT = "gt"
OPERATOR_GE = "ge"
OPERATOR_LT = "lt"
OPERATOR_IN = "in"

ALG_ENTROPY = "entropy"
ALG_GINI_INDEX = "giniIndex"
ALG_HELLINGER_DIST = "hellingerDistance"
ALG_CLASS_CONF = "classConfidenceRatio"

SPLIT_ELEMENT_SEPARATOR = ":"


# ---------------------------------------------------------------------------
# split-point / set-partition enumeration
# ---------------------------------------------------------------------------

def point_partitions(min_val: float, max_val: float, interval: float,
                     max_split: int, integer: bool) -> List[Tuple]:
    """All ordered split-point tuples within ``max_split`` segments, scanning
    by ``interval`` (SplitManager.createIntPartitions /
    createDoublePartitions, SplitManager.java:230-268,295-333).

    The recursion only extends the LAST segment, producing every ascending
    tuple of 1..max_split-1 points on the scan grid.  For int fields the
    reference's ``int`` loop variable truncates after each ``+= interval``;
    replicated via ``int()`` per step.
    """
    num_splits = int((max_val - min_val) / interval)
    if num_splits == 0:
        interval = (max_val - min_val) / 2
    out: List[Tuple] = []

    def step(cur: float) -> float:
        nxt = cur + interval
        return int(nxt) if integer else nxt

    def first() -> float:
        v = min_val + interval
        return int(v) if integer else v

    def rec(splits: Tuple) -> None:
        if len(splits) < max_split - 1:
            s = step(splits[-1])
            while s < max_val:
                ns = splits + (s,)
                out.append(ns)
                rec(ns)
                s = step(s)

    s = first()
    while s < max_val:
        ns = (s,)
        out.append(ns)
        rec(ns)
        s = step(s)
    return out


def bucket_point_partitions(field: FeatureField, max_split: int) -> List[Tuple]:
    """ClassPartitionGenerator's variant: integer grid stepping by
    ``bucketWidth`` from ``(int)(min+0.01)`` to ``(int)(max+0.01)``
    (ClassPartitionGenerator.java:279-311)."""
    min_v = int(field.min + 0.01)
    max_v = int(field.max + 0.01)
    width = int(field.bucketWidth)
    out: List[Tuple] = []

    def rec(splits: Tuple) -> None:
        if len(splits) < max_split - 1:
            for s in range(splits[-1] + width, max_v, width):
                ns = splits + (s,)
                out.append(ns)
                rec(ns)

    for s in range(min_v + width, max_v, width):
        ns = (s,)
        out.append(ns)
        rec(ns)
    return out


def categorical_partitions(cardinality: Sequence[str],
                           num_groups: int) -> List[List[List[str]]]:
    """All partitions of ``cardinality`` into exactly ``num_groups`` ordered
    groups, in the reference's construction order
    (ClassPartitionGenerator.createCatPartitions /
    SplitManager.createCategoricalPartitions, SplitManager.java:339-486):
    seed with the first ``num_groups`` elements one-per-group (plus "partial"
    prefixes one group short), then each further element either joins each
    group of a full split or forms the new last group of a partial split."""
    cardinality = list(cardinality)
    if num_groups < 2 or num_groups > len(cardinality):
        return []
    splits: List[List[List[str]]] = []
    _cat_partitions(splits, cardinality, 0, num_groups)
    return splits


def _cat_partitions(splits: List[List[List[str]]], cardinality: List[str],
                    idx: int, num_groups: int) -> None:
    if idx == 0:
        splits.append([[cardinality[i]] for i in range(num_groups)])
        splits.extend(_partial_split(cardinality, num_groups - 1, num_groups))
        _cat_partitions(splits, cardinality, num_groups, num_groups)
    elif idx < len(cardinality):
        new_splits: List[List[List[str]]] = []
        elem = cardinality[idx]
        for sp in splits:
            if len(sp) == num_groups:
                for i in range(num_groups):
                    new_splits.append(
                        [list(g) + ([elem] if j == i else [])
                         for j, g in enumerate(sp)])
            else:
                new_splits.append([list(g) for g in sp] + [[elem]])
        if idx < len(cardinality) - 1:
            new_splits.extend(_partial_split(cardinality, idx, num_groups))
        splits[:] = new_splits
        _cat_partitions(splits, cardinality, idx + 1, num_groups)


def _partial_split(cardinality: List[str], idx: int,
                   num_groups: int) -> List[List[List[str]]]:
    if num_groups == 2:
        return [[[cardinality[i] for i in range(idx + 1)]]]
    out: List[List[List[str]]] = []
    _cat_partitions(out, cardinality[:idx + 1], 0, num_groups - 1)
    return out


# ---------------------------------------------------------------------------
# splits and predicates
# ---------------------------------------------------------------------------

def int_split_key(points: Sequence) -> str:
    return SPLIT_ELEMENT_SEPARATOR.join(str(p) for p in points)


def cat_split_key(groups: Sequence[Sequence[str]]) -> str:
    """CategoricalSplit.toString: Java List.toString per group, ":"-joined
    (AttributeSplitHandler.java:205-212) -> ``[a, b]:[c]``."""
    return SPLIT_ELEMENT_SEPARATOR.join(
        "[" + ", ".join(g) + "]" for g in groups)


@dataclass
class Split:
    """One candidate split of one attribute: numeric split points or
    categorical groups; knows its reference-format key and computes segment
    indices for whole columns at once."""
    attr: int
    points: Optional[Tuple] = None             # numeric
    groups: Optional[List[List[str]]] = None   # categorical
    key: str = ""

    def __post_init__(self):
        if not self.key:
            self.key = (int_split_key(self.points) if self.points is not None
                        else cat_split_key(self.groups))

    @property
    def segment_count(self) -> int:
        if self.points is not None:
            return len(self.points) + 1
        return len(self.groups)

    def segment_index(self, column: np.ndarray) -> np.ndarray:
        """Vectorized AttributeSplitHandler.getSegmentIndex
        (AttributeSplitHandler.java:146-153: first i with value <= point;
        side='left' reproduces the strict ``>`` loop guard)."""
        if self.points is not None:
            vals = column.astype(np.float64)
            return np.searchsorted(np.asarray(self.points, dtype=np.float64),
                                   vals, side="left").astype(np.int32)
        seg = np.full(column.shape[0], -1, dtype=np.int32)
        for gi, group in enumerate(self.groups):
            seg[np.isin(column, group) & (seg < 0)] = gi
        return seg

    @classmethod
    def from_key(cls, attr: int, key: str, field: FeatureField) -> "Split":
        """IntegerSplit.fromString / CategoricalSplit.fromString
        (AttributeSplitHandler.java:158-165, 217-231)."""
        if field.is_categorical():
            groups = []
            for part in key.split(SPLIT_ELEMENT_SEPARATOR):
                part = part.strip()
                if part.startswith("["):
                    part = part[1:-1]
                groups.append([it.strip() for it in part.split(",")])
            return cls(attr, groups=groups, key=key)
        points = tuple(int(p) for p in key.split(SPLIT_ELEMENT_SEPARATOR))
        return cls(attr, points=points, key=key)


@dataclass
class AttributePredicate:
    """SplitManager.AttributePredicate and its Int/Double/Categorical
    subclasses collapsed into one record with vectorized evaluation.

    String form matches the reference: ``attr op value[ otherBound]`` for
    numerics (IntPredicate.toString), ``attr in a:b:c`` for categoricals
    (CategoricalPredicate.toString, ':'-joined values)."""
    attr: int
    operator: str
    value: Optional[float] = None
    other_bound: Optional[float] = None
    values: List[str] = dc_field(default_factory=list)
    integer: bool = True

    def to_string(self) -> str:
        if self.operator == OPERATOR_IN:
            return f"{self.attr} {OPERATOR_IN} " + ":".join(self.values)
        v = int(self.value) if self.integer else self.value
        s = f"{self.attr} {self.operator} {v}"
        if self.other_bound is not None:
            ob = int(self.other_bound) if self.integer else self.other_bound
            s += f" {ob}"
        return s

    def evaluate(self, column: np.ndarray) -> np.ndarray:
        """Vectorized SplitManager.IntPredicate/DoublePredicate/
        CategoricalPredicate.evaluate (SplitManager.java:686-721,758-787,
        824-833)."""
        if self.operator == OPERATOR_IN:
            return np.isin(column, self.values)
        col = column.astype(np.float64)
        if self.operator == OPERATOR_GE:
            r = col >= self.value
            if self.other_bound is not None:
                r &= col < self.other_bound
        elif self.operator == OPERATOR_GT:
            r = col > self.value
            if self.other_bound is not None:
                r &= col <= self.other_bound
        elif self.operator == OPERATOR_LE:
            r = col <= self.value
            if self.other_bound is not None:
                r &= col > self.other_bound
        elif self.operator == OPERATOR_LT:
            r = col < self.value
            if self.other_bound is not None:
                r &= col >= self.other_bound
        else:
            raise ValueError(f"illegal operator {self.operator}")
        return r

    @classmethod
    def parse(cls, text: str, field: FeatureField) -> "AttributePredicate":
        """Inverse of to_string (DecisionPathList.createIntPredicate etc.,
        DecisionPathList.java:196-243)."""
        items = text.split()
        attr = int(items[0])
        op = items[1]
        if field.is_categorical():
            return cls(attr, op, values=items[2].split(":"), integer=False)
        if field.is_integer():
            return cls(attr, op, value=int(items[2]),
                       other_bound=int(items[3]) if len(items) == 4 else None,
                       integer=True)
        return cls(attr, op, value=float(items[2]),
                   other_bound=float(items[3]) if len(items) == 4 else None,
                   integer=False)


def predicate_matrix(preds: Sequence[AttributePredicate],
                     col_by_attr: Dict[int, np.ndarray]) -> np.ndarray:
    """Vectorized evaluation of a predicate list over one record batch:
    bool ``B[n, len(preds)]`` with one column extraction per distinct
    attribute (``col_by_attr[attr]`` is the attribute's value column).
    This is the whole BuilderMapper predicate loop
    (DecisionTreeBuilder.java:275-320) for a batch — shared by the
    monolithic level pass and the chunked streaming pass, which calls it
    once per row chunk."""
    n = len(next(iter(col_by_attr.values()))) if col_by_attr else 0
    if not preds:
        return np.zeros((n, 0), dtype=bool)
    return np.stack([p.evaluate(col_by_attr[p.attr]) for p in preds],
                    axis=1)


def segment_predicates(split: Split, field: FeatureField) -> List[AttributePredicate]:
    """Predicates for each split segment, replicating
    SplitManager.createIntAttrPredicates / createDoubleAttrPredicates /
    createCategoricalAttrSplitPredicates (SplitManager.java:551-620,436-465)
    including the reference's overlapping last-segment ``le`` (see module
    docstring) and DoublePredicate's dropped other bound."""
    if field.is_categorical():
        return [AttributePredicate(split.attr, OPERATOR_IN, values=list(g),
                                   integer=False)
                for g in split.groups]
    integer = field.is_integer()
    pts = split.points
    preds: List[AttributePredicate] = []
    if len(pts) == 1:
        preds.append(AttributePredicate(split.attr, OPERATOR_LE, value=pts[0],
                                        integer=integer))
        preds.append(AttributePredicate(split.attr, OPERATOR_GT, value=pts[0],
                                        integer=integer))
    else:
        for i, p in enumerate(pts):
            if i == len(pts) - 1:
                preds.append(AttributePredicate(split.attr, OPERATOR_LE,
                                                value=p, integer=integer))
                preds.append(AttributePredicate(split.attr, OPERATOR_GT,
                                                value=p, integer=integer))
            elif i == 0:
                preds.append(AttributePredicate(split.attr, OPERATOR_LE,
                                                value=p, integer=integer))
            else:
                ob = pts[i - 1] if integer else None   # double drops bound
                preds.append(AttributePredicate(split.attr, OPERATOR_LE,
                                                value=p, other_bound=ob,
                                                integer=integer))
    return preds


def enumerate_attr_splits(field: FeatureField, use_bucket_grid: bool,
                          max_cat_groups: int = 3) -> List[Split]:
    """All candidate splits for one attribute.

    ``use_bucket_grid`` selects ClassPartitionGenerator's bucketWidth grid
    (ClassPartitionGenerator.java:283-286) over SplitManager's
    splitScanInterval grid (SplitManager.java:231-238)."""
    attr = field.ordinal
    max_split = int(field.maxSplit or 2)
    if field.is_categorical():
        if max_split > max_cat_groups:
            raise ValueError(
                f"more than {max_cat_groups} split groups not allowed for "
                f"categorical attr {attr}")
        splits = []
        for gr in range(2, max_split + 1):
            for groups in categorical_partitions(field.cardinality, gr):
                splits.append(Split(attr, groups=groups))
        return splits
    if use_bucket_grid:
        parts = bucket_point_partitions(field, max_split)
    else:
        parts = point_partitions(field.min, field.max,
                                 float(field.splitScanInterval),
                                 max_split, field.is_integer())
    return [Split(attr, points=p) for p in parts]


# ---------------------------------------------------------------------------
# split-quality statistics (util/AttributeSplitStat.java, InfoContentStat.java)
# ---------------------------------------------------------------------------

def info_content(counts: np.ndarray, algorithm: str) -> np.ndarray:
    """Entropy or gini over the LAST axis of a class-count tensor
    (InfoContentStat.processStat, util/InfoContentStat.java:71-101).  Zero
    counts contribute nothing (the reference never creates zero entries in
    its hash maps)."""
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        pr = np.where(total > 0, counts / total, 0.0)
        if algorithm == ALG_ENTROPY:
            term = np.where(pr > 0, -pr * np.log2(pr), 0.0)
            return term.sum(axis=-1)
        if algorithm == ALG_GINI_INDEX:
            return 1.0 - (pr * pr).sum(axis=-1)
    raise ValueError(f"unknown info algorithm {algorithm}")


def weighted_split_stat(seg_class_counts: np.ndarray, algorithm: str) -> float:
    """Population-weighted average of per-segment entropy/gini
    (AttributeSplitStat.SplitInfoContent.processStat,
    util/AttributeSplitStat.java:186-212). ``seg_class_counts``: [S, C]."""
    seg_tot = seg_class_counts.sum(axis=1)
    stats = info_content(seg_class_counts, algorithm)
    total = seg_tot.sum()
    return float((stats * seg_tot).sum() / total) if total > 0 else 0.0


def hellinger_split_stat(seg_class_counts: np.ndarray) -> float:
    """Hellinger distance over a binary-class split
    (util/AttributeSplitStat.java:240-283).  Segments with zero total count
    are skipped (the reference only materializes observed segments)."""
    if seg_class_counts.shape[1] != 2:
        raise ValueError("Hellinger distance algorithm is only valid for "
                         "binary valued class attributes")
    counts = seg_class_counts[seg_class_counts.sum(axis=1) > 0].astype(np.float64)
    class_tot = counts.sum(axis=0)
    frac = counts / np.maximum(class_tot, 1)[None, :]
    diff = np.sqrt(frac[:, 0]) - np.sqrt(frac[:, 1])
    return float(math.sqrt((diff * diff).sum()))


def class_confidence_split_stat(seg_class_counts: np.ndarray) -> float:
    """Class-confidence-ratio entropy, population-weighted across segments
    (util/AttributeSplitStat.java:289-336, 433-459)."""
    counts = seg_class_counts.astype(np.float64)
    observed = counts.sum(axis=1) > 0
    class_tot = counts.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.where(class_tot[None, :] > 0, counts / class_tot[None, :], 0.0)
        conf_tot = conf.sum(axis=1, keepdims=True)
        ccr = np.where(conf_tot > 0, conf / conf_tot, 0.0)
        ent = np.where(ccr > 0, -ccr * np.log2(ccr), 0.0).sum(axis=1)
    seg_tot = counts.sum(axis=1)
    total = seg_tot[observed].sum()
    return float((ent * seg_tot)[observed].sum() / total) if total > 0 else 0.0


def split_stat(seg_class_counts: np.ndarray, algorithm: str) -> float:
    """AttributeSplitStat.processStat dispatch
    (util/AttributeSplitStat.java:84-93)."""
    if algorithm in (ALG_ENTROPY, ALG_GINI_INDEX):
        return weighted_split_stat(seg_class_counts, algorithm)
    if algorithm == ALG_HELLINGER_DIST:
        return hellinger_split_stat(seg_class_counts)
    if algorithm == ALG_CLASS_CONF:
        return class_confidence_split_stat(seg_class_counts)
    raise ValueError(f"unknown split algorithm {algorithm}")


def split_info_content(seg_class_counts: np.ndarray) -> float:
    """Entropy of the SEGMENT populations — the gain-ratio denominator
    (AttributeSplitStat.SplitStat.getInfoContent,
    util/AttributeSplitStat.java:151-170)."""
    seg_tot = seg_class_counts.sum(axis=1).astype(np.float64)
    seg_tot = seg_tot[seg_tot > 0]
    total = seg_tot.sum()
    if total <= 0:
        return 0.0
    pr = seg_tot / total
    return float(-(pr * np.log2(pr)).sum())


def class_probabilities(seg_class_counts: np.ndarray,
                        class_values: List[str]) -> Dict[int, Dict[str, float]]:
    """Per-segment class probabilities for output.split.prob
    (AttributeSplitStat.getClassProbab)."""
    out: Dict[int, Dict[str, float]] = {}
    for si in range(seg_class_counts.shape[0]):
        tot = seg_class_counts[si].sum()
        if tot <= 0:
            continue
        out[si] = {cv: float(seg_class_counts[si, ci] / tot)
                   for ci, cv in enumerate(class_values)
                   if seg_class_counts[si, ci] > 0}
    return out
