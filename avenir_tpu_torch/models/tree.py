"""Decision tree family: split-gain generation, level-synchronous tree
growth, and physical data partitioning.

Reference surface (citations into the Java avenir sources):
- ``org.avenir.explore.ClassPartitionGenerator`` — candidate-split quality
  job: mapper enumerates splits and emits (attr, splitKey, segmentIndex,
  classVal)->1 (ClassPartitionGenerator.java:200-230), combiner sums, reducer
  accumulates AttributeSplitStat and emits gain-ratio per candidate in
  cleanup (:483-566); ``at.root`` mode emits the dataset's own info content
  (:161-163, 516-519).
- ``org.avenir.tree.SplitGenerator`` — thin wrapper deriving in/out paths
  from ``project.base.path``/``split.path`` (SplitGenerator.java:31-53).
- ``org.avenir.tree.DecisionTreeBuilder`` — one MR pass per tree level;
  mapper routes records down decision paths and emits once per satisfied
  candidate predicate (DecisionTreeBuilder.java:245-321); reducer accumulates
  per-(parentPath, childPredicate) class histograms, picks the min
  weighted-entropy/gini attribute per parent in cleanup, and writes the new
  DecisionPathList JSON (:423-538).
- ``org.avenir.tree.DataPartitioner`` — picks the best candidate split and
  physically partitions records into ``split=…/segment=…/data/`` directories
  (DataPartitioner.java:60-131, 155-201).

The port's counterpart of ``avenir_tpu/models/tree.py``, with the same
config keys, ``decpath.json`` layout, ``split=.../segment=...`` trees and
output bytes.  The mapper's per-record x per-predicate emit loop becomes a
boolean predicate matrix ``B[n, preds]`` built on the host
(``models.split``) and ONE dense (path, predicate, class) ``count_table``
on the job's device, or summed over a mesh (``sharded_reduce(mesh=)``).
The reference's bf16 one-hot contraction (``count_on_mxu``) was a TPU
choice and has no counterpart: every count here is ``count_table``, equal
to both of the reference's branches.  Split selection and the decision
file stay on the host.  With ``pipeline.chunk.rows`` a level streams
through ``core.pipeline.streaming_fold`` on one device (a mesh of several
positions is refused there).

Documented deviations from the reference (which is unexercised and carries
several blocking defects in this package):
- DecisionTreeBuilder.BuilderMapper indexes schema ordinals into the
  path-prefixed record without shifting (DecisionTreeBuilder.java:255-257:
  ``items[classField.getOrdinal()]`` while ``items[0]`` is the decision
  path), which reads the wrong columns from the second level on.  We strip
  the path prefix first so ordinals always address the original fields.
- BuilderReducer reads the class value from ``values.toString()`` — the
  Iterable's identity string — instead of each value
  (DecisionTreeBuilder.java:610), so every reference histogram collapses to
  one garbage key.  We count each record's actual class value.
- DecisionPathStoppingStrategy compares the strategy STRING to the int depth
  limit (DecisionPathStoppingStrategy.java:61 ``stoppingStrategy.equals(
  maxDepthLimit)``), making maxDepth unusable.  Implemented as intended:
  stop when ``depth >= maxDepthLimit``.
- generateRoot drops the root predicate it builds
  (DecisionTreeBuilder.java:529-537), leaving ``predicates`` null and
  breaking every later ``findDecisionPath``.  We persist the ``$root``
  predicate so iteration 2 can match it.
- Records on ``stopped`` paths pass through unchanged instead of being
  re-split forever (the reference ignores its own stopped flag,
  DecisionTreeBuilder.java:261-267 checks existence only); this is what lets
  ``run_loop`` terminate.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.binning import Vocab
from ..core.obs import traced_run
from ..core.config import JobConfig
from ..core.io import (OutputWriter, atomic_write_text, read_lines,
                       split_line, write_output)
from ..core.metrics import Counters
from ..core.schema import FeatureField, FeatureSchema
from ..device import resolve_device
from ..ops.counting import count_table, sharded_reduce
from .split import (ALG_ENTROPY, ALG_GINI_INDEX, AttributePredicate, Split,
                    class_probabilities, enumerate_attr_splits, info_content,
                    predicate_matrix, segment_predicates, split_info_content,
                    split_stat)

ROOT_PATH = "$root"
CHILD_PATH = "$child"


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _class_vocab(records: List[List[str]], class_field: FeatureField) -> Vocab:
    """Stable class-value vocabulary: declared cardinality order first, then
    first-seen discovery (core.binning.Vocab policy)."""
    vocab = Vocab(class_field.cardinality or ())
    for items in records:
        vocab.add(items[class_field.ordinal])
    return vocab


def _column(records: List[List[str]], field: FeatureField) -> np.ndarray:
    col = [items[field.ordinal] for items in records]
    if field.is_categorical():
        return np.asarray(col, dtype=object)
    return np.asarray([float(v) for v in col], dtype=np.float64)


# The count functions: ``local_fn(*arrays, mask, *static_args)`` of
# ``ops.counting.sharded_reduce`` and ``core.pipeline.streaming_fold``.

def _seg_class_count_local(seg, y, mask, n_splits, max_seg, n_class):
    """C[split, segment, class] += 1; seg is the [n, n_splits] segment-index
    matrix (the vectorized AttributeSplitHandler.getSegmentIndex)."""
    ids = torch.arange(n_splits, device=seg.device)[None, :]
    m = None if mask is None else mask[:, None]
    return count_table((n_splits, max_seg, n_class), (ids, seg, y[:, None]),
                       mask=m)


def _path_pred_class_count_local(path_id, y, bmat, mask, n_paths, n_preds,
                                 n_class, out=None):
    """C[path, predicate, class] += 1 where bmat[n, preds] marks satisfied
    predicates: the whole BuilderMapper emit loop + shuffle + BuilderReducer
    histogram (DecisionTreeBuilder.java:245-321,350-423) as one pass.  With
    ``out`` (a streamed fold's carry) the counts are added into it."""
    ids = torch.arange(n_preds, device=bmat.device)[None, :]
    m = bmat if mask is None else bmat & mask[:, None]
    counts = count_table((n_paths, n_preds, n_class),
                         (path_id[:, None], ids, y[:, None]), mask=m)
    if out is None:
        return counts
    out += counts
    return out


def _class_count_local(y, mask, n_class):
    return count_table((n_class,), (y,), mask=mask)


def _count(local_fn, *arrays, device, mesh, static_args) -> np.ndarray:
    """``local_fn`` over host row arrays on ``device``, or summed over
    ``mesh`` when one is given; the table comes back to the host."""
    kw = {"mesh": mesh} if mesh is not None else {"device": device}
    return sharded_reduce(local_fn, *arrays, static_args=static_args,
                          **kw).cpu().numpy()


# ---------------------------------------------------------------------------
# ClassPartitionGenerator
# ---------------------------------------------------------------------------

class ClassPartitionGenerator:
    """Candidate-split gain job (explore/ClassPartitionGenerator.java)."""

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)
        self.rng = random.Random(config.get_int("seed", None))

    def _split_attributes(self) -> List[int]:
        """Attribute selection (ClassPartitionGenerator.java:159-196)."""
        strategy = self.config.get("split.attribute.selection.strategy",
                                   "userSpecified")
        ordinals = [f.ordinal for f in self.schema.feature_fields()]
        if strategy == "userSpecified":
            attrs = self.config.must("split.attributes")
            return [int(a) for a in attrs.split(",")]
        if strategy in ("all", "notUsedYet"):
            # notUsedYet's used-attribute tracking is a TODO in the reference
            # (ClassPartitionGenerator.java:173) and degrades to all
            return ordinals
        if strategy == "random":
            k = self.config.get_int("random.split.set.size", 3)
            picked: set = set()
            while len(picked) != min(k, len(ordinals)):
                picked.add(self.rng.choice(ordinals))
            return sorted(picked)
        raise ValueError(
            f"invalid splitting attribute selection strategy {strategy}")

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        algorithm = self.config.get("split.algorithm", ALG_GINI_INDEX)
        at_root = self.config.get_boolean("at.root", False)
        output_split_prob = self.config.get_boolean("output.split.prob", False)

        records = [split_line(l, delim_regex) for l in read_lines(in_path)]
        counters.set("Basic", "Records", len(records))
        class_field = self.schema.class_attr_field()
        class_vocab = _class_vocab(records, class_field)
        class_values = class_vocab.values
        n_class = len(class_values)
        y = np.asarray([class_vocab[r[class_field.ordinal]] for r in records],
                       dtype=np.int32)

        if at_root:
            # dataset-level info content (ClassPartitionGenerator.java:161-163,
            # 516-519)
            counts = _count(_class_count_local, y, device=self.device,
                            mesh=mesh, static_args=(n_class,))
            stat = float(info_content(counts, algorithm))
            write_output(out_path, [str(stat)])
            return counters

        parent_info = self.config.get_float("parent.info", None)
        if parent_info is None and algorithm in (ALG_ENTROPY, ALG_GINI_INDEX):
            raise ValueError("parent.info must be set (output of the at.root "
                             "run) for entropy/gini gain computation")
        max_cat_groups = self.config.get_int("max.cat.attr.split.groups", 3)

        # enumerate all candidate splits for the selected attributes and
        # compute the [n, n_splits] segment-index matrix (host, vectorized)
        attrs = self._split_attributes()
        splits: List[Split] = []
        seg_cols: List[np.ndarray] = []
        for attr in attrs:
            field = self.schema.field_by_ordinal(attr)
            col = _column(records, field)
            for sp in enumerate_attr_splits(field, use_bucket_grid=True,
                                            max_cat_groups=max_cat_groups):
                splits.append(sp)
                seg = sp.segment_index(col)
                if (seg < 0).any():
                    # CategoricalSplit.getSegmentIndex throws for values
                    # outside every group (AttributeSplitHandler.java:196-199)
                    bad = col[int(np.nonzero(seg < 0)[0][0])]
                    raise ValueError(f"split segment not found for {bad}")
                seg_cols.append(seg)
        if not splits:
            write_output(out_path, [])
            return counters

        seg = np.stack(seg_cols, axis=1).astype(np.int32)
        max_seg = max(sp.segment_count for sp in splits)
        counters.set("Stats", "mapper output count", len(records) * len(splits))

        counts = _count(_seg_class_count_local, seg, y, device=self.device,
                        mesh=mesh, static_args=(len(splits), max_seg, n_class))

        # reducer cleanup: per-split stats -> gain ratio lines
        # (ClassPartitionGenerator.java:513-553)
        lines: List[str] = []
        for si, sp in enumerate(splits):
            seg_counts = counts[si, :sp.segment_count, :]
            stat = split_stat(seg_counts, algorithm)
            if algorithm in (ALG_ENTROPY, ALG_GINI_INDEX):
                gain = parent_info - stat
                denom = split_info_content(seg_counts)
                gain_ratio = gain / denom if denom else 0.0
                line = f"{sp.attr}{delim}{sp.key}{delim}{gain_ratio}"
                if output_split_prob:
                    pr = class_probabilities(seg_counts, class_values)
                    ser = delim.join(
                        f"{si2}{delim}{cv}{delim}{p}"
                        for si2, cps in pr.items() for cv, p in cps.items())
                    line += delim + ser
            else:
                line = f"{sp.attr}{delim}{sp.key}{delim}{stat}"
            lines.append(line)
        counters.set("Stats", "reducer input count",
                     int((counts.sum(axis=-1) > 0).sum()))
        write_output(out_path, lines)
        return counters


class SplitGenerator(ClassPartitionGenerator):
    """Derives in/out from project.base.path / split.path
    (tree/SplitGenerator.java:36-53): in = base/split=root/data[/<split
    path>], out = sibling 'splits' directory."""

    def node_paths(self) -> Tuple[str, str]:
        base = self.config.must("project.base.path")
        split_path = self.config.get("split.path")
        in_path = os.path.join(base, "split=root", "data")
        if split_path:
            in_path = os.path.join(in_path, split_path)
        return in_path, os.path.join(os.path.dirname(in_path), "splits")

    @traced_run
    def run(self, in_path: Optional[str] = None,
            out_path: Optional[str] = None, mesh=None) -> Counters:
        if self.config.get("project.base.path"):
            in_path, out_path = self.node_paths()
        return super().run(in_path, out_path, mesh=mesh)


# ---------------------------------------------------------------------------
# DecisionPathList (JSON model checkpoint)
# ---------------------------------------------------------------------------

@dataclass
class DecisionPath:
    """tree/DecisionPathList.java DecisionPath bean."""
    predicate_strs: List[str]
    population: int = 0
    info_content: float = 0.0
    stopped: bool = False

    @property
    def path_str(self) -> str:
        return ";".join(self.predicate_strs)

    def depth(self) -> int:
        return len(self.predicate_strs)


class DecisionPathList:
    """JSON (de)serialization compatible with the reference's Jackson bean
    layout (predicates carry attribute/operator/values plus predicateStr;
    matching is by predicateStr, DecisionPathList.java:120-131)."""

    def __init__(self, paths: Optional[List[DecisionPath]] = None):
        self.paths: List[DecisionPath] = paths or []

    def add(self, path: DecisionPath) -> None:
        self.paths.append(path)

    def find(self, predicate_strs: Sequence[str]) -> Optional[DecisionPath]:
        want = list(predicate_strs)
        for p in self.paths:
            if p.predicate_strs == want:
                return p
        return None

    def find_str(self, path_str: str, delim: str = ";") -> Optional[DecisionPath]:
        return self.find(path_str.split(delim))

    def all_stopped(self) -> bool:
        return all(p.stopped for p in self.paths)

    def to_json(self, schema: FeatureSchema) -> str:
        out = []
        for p in self.paths:
            preds = []
            for ps in p.predicate_strs:
                bean: Dict = {"predicateStr": ps}
                if ps != ROOT_PATH:
                    attr = int(ps.split()[0])
                    field = schema.field_by_ordinal(attr)
                    pred = AttributePredicate.parse(ps, field)
                    bean.update({
                        "attribute": pred.attr,
                        "operator": pred.operator,
                        "valueInt": int(pred.value)
                        if pred.value is not None and pred.integer else 0,
                        "valueDbl": float(pred.value)
                        if pred.value is not None else 0.0,
                        "categoricalValues": pred.values or None,
                        "otherBoundInt": int(pred.other_bound)
                        if pred.other_bound is not None and pred.integer else None,
                        "otherBoundDbl": float(pred.other_bound)
                        if pred.other_bound is not None else None,
                    })
                preds.append(bean)
            out.append({"predicates": preds, "population": p.population,
                        "infoContent": p.info_content, "stopped": p.stopped})
        return json.dumps({"decisionPaths": out}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "DecisionPathList":
        d = json.loads(text)
        paths = []
        for pd in d.get("decisionPaths", []):
            preds = [b["predicateStr"] for b in (pd.get("predicates") or [])]
            paths.append(DecisionPath(preds, pd.get("population", 0),
                                      pd.get("infoContent", 0.0),
                                      pd.get("stopped", False)))
        return cls(paths)

    @classmethod
    def from_file(cls, path: str) -> "DecisionPathList":
        with open(path) as fh:
            return cls.from_json(fh.read())


class DecisionPathStoppingStrategy:
    """tree/DecisionPathStoppingStrategy.java:43-71 (maxDepth implemented as
    intended — see module docstring)."""

    STOP_MAX_DEPTH = "maxDepth"
    STOP_MIN_POPULATION = "minPopulation"
    STOP_MIN_INFO_GAIN = "minInfoGain"

    def __init__(self, strategy: str, max_depth_limit: int = -1,
                 min_info_gain_limit: float = -1.0,
                 min_population_limit: int = -1):
        self.strategy = strategy
        self.max_depth_limit = max_depth_limit
        self.min_info_gain_limit = min_info_gain_limit
        self.min_population_limit = min_population_limit

    @classmethod
    def from_config(cls, config: JobConfig) -> "DecisionPathStoppingStrategy":
        strategy = config.get("path.stopping.strategy", cls.STOP_MIN_INFO_GAIN)
        max_depth = -1
        min_gain = -1.0
        min_pop = -1
        if strategy == cls.STOP_MAX_DEPTH:
            max_depth = config.must_int("max.depth.limit",
                                        "missing max depth limit for tree")
        elif strategy == cls.STOP_MIN_INFO_GAIN:
            min_gain = config.must_float("min.info.gain.limit",
                                         "missing min info gain limit")
        elif strategy == cls.STOP_MIN_POPULATION:
            min_pop = config.must_int("min.population.limit",
                                      "missing min population limit")
        else:
            raise ValueError(f"invalid stopping strategy {strategy}")
        return cls(strategy, max_depth, min_gain, min_pop)

    def should_stop(self, total_count: int, stat: float, parent_stat: float,
                    depth: int) -> bool:
        if self.strategy == self.STOP_MIN_POPULATION:
            return total_count < self.min_population_limit
        if self.strategy == self.STOP_MIN_INFO_GAIN:
            return (parent_stat - stat) < self.min_info_gain_limit
        if self.strategy == self.STOP_MAX_DEPTH:
            return depth >= self.max_depth_limit
        raise ValueError(f"invalid stopping strategy {self.strategy}")


# ---------------------------------------------------------------------------
# DecisionTreeBuilder
# ---------------------------------------------------------------------------

class DecisionTreeBuilder:
    """Level-synchronous tree/random-forest growth; one call = one reference
    job run = one tree level (tree/DecisionTreeBuilder.java)."""

    ATTR_SEL_ALL = "all"
    ATTR_SEL_NOT_USED_YET = "notUsedYet"
    ATTR_SEL_RANDOM_ALL = "randomAll"
    ATTR_SEL_RANDOM_NOT_USED_YET = "randomNotUsedYet"

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)
        self.decision_file = config.must("decision.file.path")
        self.dec_path_delim = config.get("dec.path.delim", ";")
        self.algorithm = config.get("split.algorithm", ALG_GINI_INDEX)
        self.attr_select_strategy = config.get(
            "split.attribute.selection.strategy", self.ATTR_SEL_NOT_USED_YET)
        self.random_split_set_size = config.get_int("random.split.set.size", 3)
        self.rng = random.Random(config.get_int("seed", None))

    # -- attribute selection (DecisionTreeBuilder.java:327-343) -----------
    def _candidate_attrs(self, used: Sequence[int]) -> List[int]:
        ordinals = [f.ordinal for f in self.schema.feature_fields()]
        strategy = self.attr_select_strategy
        if strategy == self.ATTR_SEL_ALL:
            return ordinals
        if strategy == self.ATTR_SEL_NOT_USED_YET:
            return [o for o in ordinals if o not in set(used)]
        if strategy == self.ATTR_SEL_RANDOM_ALL:
            k = min(self.random_split_set_size, len(ordinals))
            return sorted(self.rng.sample(ordinals, k))
        if strategy == self.ATTR_SEL_RANDOM_NOT_USED_YET:
            remaining = [o for o in ordinals if o not in set(used)]
            k = min(self.random_split_set_size, len(remaining))
            return sorted(self.rng.sample(remaining, k))
        raise ValueError(
            f"invalid splitting attribute selection strategy {strategy}")

    # -- sub-sampling (DecisionTreeBuilder.java:164-223; random-forest hook)
    def _subsample(self, lines: List[str]) -> List[str]:
        strategy = self.config.get("sub.sampling.strategy", "withReplace")
        if strategy == "none":
            return lines
        if strategy == "withoutReplace":
            rate = self.config.must_int(
                "sub.sampling.rate",
                "samling rate should be provided for sampling without replacement")
            return [l for l in lines if self.rng.random() * 100 < rate]
        if strategy == "withReplace":
            # chunked bootstrap: the reference buffers batches and emits
            # |batch| uniform draws with replacement per batch
            size = self.config.get_int("sub.sampling.buffer.size", 10000)
            out: List[str] = []
            for start in range(0, len(lines), size):
                chunk = lines[start:start + size]
                out.extend(self.rng.choice(chunk) for _ in range(len(chunk)))
            return out
        raise ValueError(f"invalid sub sampling strategy {strategy}")

    def tree_available(self) -> bool:
        return (os.path.exists(self.decision_file)
                and os.path.getsize(self.decision_file) > 0)

    # rough per-record device bytes (pid + class + predicate booleans) for
    # pipeline.device.budget.bytes chunk sizing
    _BUDGET_ROW_BYTES = 128

    # -- one level ---------------------------------------------------------
    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        if not self.tree_available():
            return self._run_root(in_path, out_path, counters, mesh=mesh)
        chunk_rows = self.config.pipeline_chunk_rows(
            row_bytes=self._BUDGET_ROW_BYTES)
        if chunk_rows is not None:
            res = self._run_level_streamed(
                in_path, out_path, counters, mesh, chunk_rows,
                self.config.pipeline_prefetch_depth())
            if res is not None:
                return res
            counters = Counters()     # fallback re-runs from scratch
        return self._run_level(in_path, out_path, counters, mesh=mesh)

    def _enum_preds(self, all_attrs: Sequence[int]
                    ) -> Tuple[List[AttributePredicate], List[int]]:
        """Schema-only candidate predicate enumeration for a level pass
        (data-independent, so the streamed pass can fix its count extents
        before any record is read)."""
        preds: List[AttributePredicate] = []
        pred_attr: List[int] = []
        for attr in all_attrs:
            field = self.schema.field_by_ordinal(attr)
            for sp in enumerate_attr_splits(field, use_bucket_grid=False):
                for pred in segment_predicates(sp, field):
                    preds.append(pred)
                    pred_attr.append(attr)
        return preds, pred_attr

    def _level_cleanup(self, path_objs, active, passthrough, cand_attrs,
                       preds, pred_attr, counts, stopping
                       ) -> Tuple[DecisionPathList, Dict[int, int]]:
        """Reducer cleanup (generateTree, DecisionTreeBuilder.java:423-538):
        per parent, group predicate stats by attribute, min weighted stat —
        shared verbatim by the monolithic and streamed level passes."""
        new_dpl = DecisionPathList()
        selected_attr: Dict[int, int] = {}
        n_paths = len(path_objs)
        for pid in range(n_paths):
            parent = path_objs[pid]
            if parent is None or not active[pid]:
                if parent is not None and passthrough[pid]:
                    new_dpl.add(parent)
                continue
            pred_tot = counts[pid].sum(axis=1)            # [K]
            pred_stat = info_content(counts[pid], self.algorithm)
            best_attr = None
            min_info = 1000.0
            for attr in cand_attrs[pid]:
                sel = np.asarray([a == attr for a in pred_attr]) & (pred_tot > 0)
                tot = pred_tot[sel].sum()
                if tot == 0:
                    continue
                av = float((pred_stat[sel] * pred_tot[sel]).sum() / tot)
                if av < min_info:
                    min_info = av
                    best_attr = attr
            if best_attr is None:
                parent.stopped = True
                new_dpl.add(parent)
                continue
            selected_attr[pid] = best_attr
            parent_preds = [p for p in path_objs[pid].predicate_strs
                            if p != ROOT_PATH]
            parent_stat = path_objs[pid].info_content
            for k, pred in enumerate(preds):
                if pred_attr[k] != best_attr or pred_tot[k] == 0:
                    continue
                stat_k = float(pred_stat[k])
                # depth = the child path's own predicate count (the "$root"
                # sentinel never counts — DecisionPath.depth() parity)
                stop = stopping.should_stop(int(pred_tot[k]), stat_k,
                                            parent_stat,
                                            len(parent_preds) + 1)
                new_dpl.add(DecisionPath(
                    parent_preds + [pred.to_string()],
                    int(pred_tot[k]), stat_k, stop))
        return new_dpl, selected_attr

    def _run_root(self, in_path: str, out_path: str, counters: Counters,
                  mesh=None) -> Counters:
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        lines = self._subsample(list(read_lines(in_path)))
        records = [split_line(l, delim_regex) for l in lines]
        counters.set("Basic", "Records", len(records))

        class_field = self.schema.class_attr_field()
        class_vocab = _class_vocab(records, class_field)
        y = np.asarray([class_vocab[r[class_field.ordinal]] for r in records],
                       dtype=np.int32)
        counts = _count(_class_count_local, y, device=self.device, mesh=mesh,
                        static_args=(len(class_vocab),))
        stat = float(info_content(counts, self.algorithm))

        dpl = DecisionPathList(
            [DecisionPath([ROOT_PATH], int(counts.sum()), stat, False)])
        atomic_write_text(self.decision_file, dpl.to_json(self.schema))
        write_output(out_path, (f"{ROOT_PATH}{delim}{l}" for l in lines))
        return counters

    def _run_level(self, in_path: str, out_path: str, counters: Counters,
                   mesh=None) -> Counters:
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        dpl = DecisionPathList.from_file(self.decision_file)
        stopping = DecisionPathStoppingStrategy.from_config(self.config)

        # split the path prefix off each record (see deviation note: ordinals
        # address the original fields)
        raw = list(read_lines(in_path))
        counters.set("Basic", "Records", len(raw))
        path_strs: List[str] = []
        records: List[List[str]] = []
        rests: List[str] = []
        for line in raw:
            pos = line.find(delim)
            path_strs.append(line[:pos])
            rest = line[pos + len(delim):]
            rests.append(rest)
            records.append(split_line(rest, delim_regex))

        # path vocabulary + per-path status
        path_vocab: Dict[str, int] = {}
        for ps in path_strs:
            path_vocab.setdefault(ps, len(path_vocab))
        n_paths = len(path_vocab)
        path_objs: List[Optional[DecisionPath]] = [None] * n_paths
        for ps, pid in path_vocab.items():
            path_objs[pid] = dpl.find_str(ps, self.dec_path_delim)

        path_id = np.asarray([path_vocab[ps] for ps in path_strs],
                             dtype=np.int32)
        active = np.asarray(
            [p is not None and not p.stopped for p in path_objs], dtype=bool)
        passthrough = np.asarray(
            [p is not None and p.stopped for p in path_objs], dtype=bool)
        record_active = active[path_id]

        # per-path candidate attributes -> union predicate list
        used_by_path: List[List[int]] = []
        for p in path_objs:
            used: List[int] = []
            if p is not None:
                for ps in p.predicate_strs:
                    if ps != ROOT_PATH:
                        used.append(int(ps.split()[0]))
            used_by_path.append(used)
        cand_attrs = [self._candidate_attrs(used_by_path[pid])
                      if active[pid] else []
                      for pid in range(n_paths)]
        all_attrs = sorted({a for attrs in cand_attrs for a in attrs})

        preds, pred_attr = self._enum_preds(all_attrs)
        if not preds:
            # nothing left to split on: mark all active paths stopped
            for p in path_objs:
                if p is not None:
                    p.stopped = True
            atomic_write_text(self.decision_file, DecisionPathList(
                [p for p in path_objs if p is not None]
            ).to_json(self.schema))
            write_output(out_path, (raw[i] for i in range(len(raw))
                                    if path_objs[path_id[i]] is not None))
            return counters

        col_by_attr = {attr: _column(records, self.schema.field_by_ordinal(attr))
                       for attr in all_attrs}
        bmat = predicate_matrix(preds, col_by_attr)
        allowed = np.zeros((n_paths, len(preds)), dtype=bool)
        for pid in range(n_paths):
            cset = set(cand_attrs[pid])
            allowed[pid] = np.asarray([a in cset for a in pred_attr])

        class_field = self.schema.class_attr_field()
        class_vocab = _class_vocab(records, class_field)
        n_class = len(class_vocab)
        y = np.asarray([class_vocab[r[class_field.ordinal]] for r in records],
                       dtype=np.int32)

        counts = _count(_path_pred_class_count_local, path_id, y,
                        bmat & record_active[:, None], device=self.device,
                        mesh=mesh, static_args=(n_paths, len(preds), n_class))
        counts = counts * allowed[:, :, None]

        new_dpl, selected_attr = self._level_cleanup(
            path_objs, active, passthrough, cand_attrs, preds, pred_attr,
            counts, stopping)

        atomic_write_text(self.decision_file,
                          new_dpl.to_json(self.schema))

        # output: every record once per satisfied predicate OF THE SELECTED
        # attribute, path extended; stopped paths pass through.  (The
        # reference's reducer passes through every candidate predicate's
        # records, DecisionTreeBuilder.java:608-612, but the next level drops
        # all non-selected paths at the dpl lookup — emitting them is pure
        # inflation, so we emit only lines the next level can consume.)
        out_lines: List[str] = []
        pred_strs = [p.to_string() for p in preds]
        sel_mask = np.zeros((n_paths, len(preds)), dtype=bool)
        for pid, attr in selected_attr.items():
            sel_mask[pid] = np.asarray([a == attr for a in pred_attr])
        for i in range(len(records)):
            pid = path_id[i]
            if passthrough[pid]:
                out_lines.append(raw[i])
                continue
            if not active[pid] or pid not in selected_attr:
                continue
            base = path_strs[i]
            if base == ROOT_PATH:
                base = ""
            for k in np.nonzero(bmat[i] & sel_mask[pid])[0]:
                prefix = (base + self.dec_path_delim if base else "") + pred_strs[k]
                out_lines.append(f"{prefix}{delim}{rests[i]}")
        counters.set("Stats", "output records", len(out_lines))
        write_output(out_path, out_lines)
        return counters

    def _stream_device(self, mesh) -> torch.device:
        if mesh is None:
            return self.device
        if mesh.size != 1:
            raise NotImplementedError(
                "the streamed tree level (pipeline.chunk.rows) runs on one "
                "device; a mesh of several positions is not ported yet")
        return mesh.devices.flat[0]

    def _run_level_streamed(self, in_path: str, out_path: str,
                            counters: Counters, mesh, chunk_rows: int,
                            depth: int) -> Optional[Counters]:
        """Out-of-core level pass: two streaming passes over row chunks.

        Pass 1 folds the C[path, predicate, class] histogram through
        ``core.pipeline`` (double-buffered, accumulated in place) while
        discovering the path/class vocabularies in input order; pass 2
        re-streams the input and emits the routed records chunk by chunk,
        so peak memory is O(chunk) regardless of input size.  The count
        extents are fixed BEFORE reading any data: active paths and their
        candidate attributes come from the decision file, predicates from
        the schema (``_enum_preds``).  Output — decision-file JSON and
        routed records — is bit-identical to ``_run_level``; cases whose
        parity cannot be guaranteed return None and the caller falls back:
        random attribute-selection strategies (the RNG draw order follows
        path DISCOVERY order, unknowable before reading the data) and
        class values first appearing after the first chunk beyond the
        declared cardinality + headroom."""
        from ..core import pipeline
        from ..core.binning import ChunkedEncodeUnsupported

        if self.attr_select_strategy in (self.ATTR_SEL_RANDOM_ALL,
                                         self.ATTR_SEL_RANDOM_NOT_USED_YET):
            return None
        device = self._stream_device(mesh)
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        dpl = DecisionPathList.from_file(self.decision_file)
        stopping = DecisionPathStoppingStrategy.from_config(self.config)
        class_field = self.schema.class_attr_field()

        # static extents from the decision file + schema (data-free)
        active_dpl = [p for p in dpl.paths if not p.stopped]
        akey = {tuple(p.predicate_strs): i for i, p in enumerate(active_dpl)}
        cand_by_aid = []
        for p in active_dpl:
            used = [int(ps.split()[0]) for ps in p.predicate_strs
                    if ps != ROOT_PATH]
            cand_by_aid.append(self._candidate_attrs(used))
        sup_attrs = sorted({a for attrs in cand_by_aid for a in attrs})
        preds_sup, pred_attr_sup = self._enum_preds(sup_attrs)
        K = len(preds_sup)
        a_cap = max(len(active_dpl), 1)

        # streaming discovery state (chunks are consumed sequentially, so
        # discovery order == the monolithic pass's record order)
        path_vocab: Dict[str, int] = {}
        aid_of_ps: Dict[str, int] = {}
        class_vocab = Vocab(class_field.cardinality or ())
        cap = [None]
        n_records = [0]

        def parse_chunk(lines):
            path_c: List[str] = []
            rests: List[str] = []
            recs: List[List[str]] = []
            for line in lines:
                pos = line.find(delim)
                path_c.append(line[:pos])
                rest = line[pos + len(delim):]
                rests.append(rest)
                recs.append(split_line(rest, delim_regex))
            return path_c, rests, recs

        def encode_chunk(lines):
            path_c, _, recs = parse_chunk(lines)
            apid = np.empty(len(lines), dtype=np.int32)
            for i, ps in enumerate(path_c):
                aid = aid_of_ps.get(ps)
                if aid is None:
                    path_vocab.setdefault(ps, len(path_vocab))
                    aid = akey.get(tuple(ps.split(self.dec_path_delim)), -1)
                    aid_of_ps[ps] = aid
                apid[i] = aid
            y = np.asarray([class_vocab.add(r[class_field.ordinal])
                            for r in recs], dtype=np.int32)
            if cap[0] is not None and len(class_vocab) > cap[0]:
                raise ChunkedEncodeUnsupported("late class value")
            col_by_attr = {a: _column(recs, self.schema.field_by_ordinal(a))
                           for a in sup_attrs}
            return apid, y, predicate_matrix(preds_sup, col_by_attr)

        def chunks():
            for lines in pipeline.iter_line_chunks(in_path, chunk_rows):
                n_records[0] += len(lines)
                yield encode_chunk(lines)

        try:
            first, stream = pipeline.peek(chunks())
            cap[0] = n_class_cap = max(len(class_vocab), 1) + 2
            if K:
                counts_sup = pipeline.streaming_fold(
                    stream, _path_pred_class_count_local,
                    static_args=(a_cap, K, n_class_cap), device=device,
                    prefetch_depth=depth)
            else:
                for _ in stream:      # discovery only; nothing to count
                    pass
                counts_sup = None
        except ChunkedEncodeUnsupported:
            return None
        counters.set("Basic", "Records", n_records[0])

        # reconstruct the monolithic pass's discovery-order state
        n_paths = len(path_vocab)
        path_objs: List[Optional[DecisionPath]] = [None] * n_paths
        for ps, pid in path_vocab.items():
            path_objs[pid] = dpl.find_str(ps, self.dec_path_delim)
        active = np.asarray(
            [p is not None and not p.stopped for p in path_objs], dtype=bool)
        passthrough = np.asarray(
            [p is not None and p.stopped for p in path_objs], dtype=bool)
        used_by_path = []
        for p in path_objs:
            used = []
            if p is not None:
                for ps in p.predicate_strs:
                    if ps != ROOT_PATH:
                        used.append(int(ps.split()[0]))
            used_by_path.append(used)
        cand_attrs = [self._candidate_attrs(used_by_path[pid])
                      if active[pid] else [] for pid in range(n_paths)]
        all_attrs = sorted({a for attrs in cand_attrs for a in attrs})
        # the predicate list the monolithic pass would have built (the
        # superset pass counted extra attributes of non-appearing paths;
        # selecting the appearing-attr columns restores exact parity,
        # including the all-paths-exhausted early branch below)
        attr_set = set(all_attrs)
        sel_cols = [k for k in range(K) if pred_attr_sup[k] in attr_set]
        preds = [preds_sup[k] for k in sel_cols]
        pred_attr = [pred_attr_sup[k] for k in sel_cols]

        if not preds:
            for p in path_objs:
                if p is not None:
                    p.stopped = True
            atomic_write_text(self.decision_file, DecisionPathList(
                [p for p in path_objs if p is not None]
            ).to_json(self.schema))
            with OutputWriter(out_path) as w:
                for lines in pipeline.iter_line_chunks(in_path, chunk_rows):
                    path_c, _, _ = parse_chunk(lines)
                    for i, line in enumerate(lines):
                        if path_objs[path_vocab[path_c[i]]] is not None:
                            w.write(line)
            return counters

        n_class = len(class_vocab)
        counts = np.zeros((n_paths, len(preds), n_class), dtype=np.int32)
        if counts_sup is not None:
            for ps, pid in path_vocab.items():
                aid = aid_of_ps[ps]
                if aid >= 0 and active[pid]:
                    counts[pid] = counts_sup[aid][sel_cols][:, :n_class]
        allowed = np.zeros((n_paths, len(preds)), dtype=bool)
        for pid in range(n_paths):
            cset = set(cand_attrs[pid])
            allowed[pid] = np.asarray([a in cset for a in pred_attr])
        counts = counts * allowed[:, :, None]

        new_dpl, selected_attr = self._level_cleanup(
            path_objs, active, passthrough, cand_attrs, preds, pred_attr,
            counts, stopping)
        atomic_write_text(self.decision_file,
                          new_dpl.to_json(self.schema))

        # pass 2: re-stream the input and emit routed records per chunk.
        # Only predicates of SELECTED attributes are ever consulted here
        # (sel_mask), so the per-chunk evaluation is restricted to them —
        # the emission order over the reduced list matches the monolithic
        # full-list scan because both ascend in preds order.
        sel_attr_set = set(selected_attr.values())
        emit_cols = [k for k in range(len(preds))
                     if pred_attr[k] in sel_attr_set]
        emit_preds = [preds[k] for k in emit_cols]
        emit_strs = [preds[k].to_string() for k in emit_cols]
        sel_mask = np.zeros((n_paths, len(emit_cols)), dtype=bool)
        for pid, attr in selected_attr.items():
            sel_mask[pid] = np.asarray([pred_attr[k] == attr
                                        for k in emit_cols])
        n_out = 0
        with OutputWriter(out_path) as w:
            for lines in pipeline.iter_line_chunks(in_path, chunk_rows):
                path_c, rests, recs = parse_chunk(lines)
                col_by_attr = {
                    a: _column(recs, self.schema.field_by_ordinal(a))
                    for a in sorted(sel_attr_set)}
                bmat = predicate_matrix(emit_preds, col_by_attr) \
                    if emit_cols else np.zeros((len(lines), 0), bool)
                for i, line in enumerate(lines):
                    pid = path_vocab[path_c[i]]
                    if passthrough[pid]:
                        w.write(line)
                        n_out += 1
                        continue
                    if not active[pid] or pid not in selected_attr:
                        continue
                    base = path_c[i]
                    if base == ROOT_PATH:
                        base = ""
                    for k in np.nonzero(bmat[i] & sel_mask[pid])[0]:
                        prefix = ((base + self.dec_path_delim if base else "")
                                  + emit_strs[k])
                        w.write(f"{prefix}{delim}{rests[i]}")
                        n_out += 1
        counters.set("Stats", "output records", n_out)
        return counters

    # -- host-side multi-level loop (the reference re-runs the job by hand
    # per level) -----------------------------------------------------------
    def run_loop(self, in_path: str, work_dir: str, max_levels: int = 10,
                 mesh=None) -> DecisionPathList:
        os.makedirs(work_dir, exist_ok=True)
        cur = in_path
        for level in range(max_levels):
            out = os.path.join(work_dir, f"level_{level}")
            self.run(cur, out, mesh=mesh)
            cur = out
            dpl = DecisionPathList.from_file(self.decision_file)
            if level > 0 and dpl.all_stopped():
                break
        return DecisionPathList.from_file(self.decision_file)


# ---------------------------------------------------------------------------
# DataPartitioner
# ---------------------------------------------------------------------------

class DataPartitioner:
    """Physically partitions records by the best candidate split
    (tree/DataPartitioner.java).  Candidate-split lines are ';'-delimited
    ``attr;splitKey;stat`` (see split.py module docstring on the reference's
    delimiter inconsistency); selection is 'best' (max stat) or
    'randomFromTop' (DataPartitioner.java:160-186); output goes to
    ``<node>/split=<idx>/segment=<i>/data/partition.txt``
    (DataPartitioner.java:115-131)."""

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        # host NumPy only; the device is resolved as every job's is
        self.device = resolve_device(device)
        self.rng = random.Random(config.get_int("seed", None))

    def node_path(self) -> str:
        base = self.config.must("project.base.path", "base path not defined")
        split_path = self.config.get("split.path")
        node = os.path.join(base, "split=root", "data")
        if split_path:
            node = os.path.join(node, split_path)
        return node

    def _find_best_split(self, candidates_path: str) -> Tuple[int, Split, int]:
        lines = list(read_lines(candidates_path))
        parsed = []
        for i, line in enumerate(lines):
            items = line.split(";")
            parsed.append((float(items[2]), i, int(items[0]), items[1]))
        parsed.sort(key=lambda t: -t[0])
        strategy = self.config.get("split.selection.strategy", "best")
        idx = 0
        if strategy == "randomFromTop":
            n_top = self.config.get_int("num.top.splits", 5)
            idx = int(self.rng.random() * min(n_top, len(parsed)))
        _, orig_index, attr, key = parsed[idx]
        field = self.schema.field_by_ordinal(attr)
        return attr, Split.from_key(attr, key, field), orig_index

    @traced_run
    def run(self, in_path: Optional[str] = None,
            out_path: Optional[str] = None, mesh=None) -> Counters:
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        # the reference derives both paths strictly from config
        # (DataPartitioner.java:135-149); positional args only apply when no
        # base path is configured (so the generic CLI arg shape still works)
        node = self.node_path() if self.config.get("project.base.path") \
            else in_path
        candidates = (self.config.get("candidate.splits.path")
                      or os.path.join(os.path.dirname(node.rstrip("/")),
                                      "splits", "part-r-00000"))
        attr, split, index = self._find_best_split(candidates)

        out_base = (os.path.join(node, f"split={index}")
                    if self.config.get("project.base.path") else out_path)
        lines = list(read_lines(node))
        records = [split_line(l, delim_regex) for l in lines]
        field = self.schema.field_by_ordinal(attr)
        seg = split.segment_index(_column(records, field))
        if (seg < 0).any():
            bad = records[int(np.nonzero(seg < 0)[0][0])][field.ordinal]
            raise ValueError(f"split segment not found for {bad}")

        for si in range(split.segment_count):
            seg_dir = os.path.join(out_base, f"segment={si}", "data")
            os.makedirs(seg_dir, exist_ok=True)
            atomic_write_text(
                os.path.join(seg_dir, "partition.txt"),
                "".join(lines[i] + "\n" for i in np.nonzero(seg == si)[0]))
            counters.set("Partition", f"segment {si}",
                         int((seg == si).sum()))
        return counters
