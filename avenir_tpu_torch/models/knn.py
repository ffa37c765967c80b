"""k-nearest-neighbor pipeline on one CUDA card: the distance job, the
probability joiner and the voting classifier.

The port's counterpart of ``avenir_tpu/models/knn.py``, with the same
config keys, input layouts and output bytes:

- ``SameTypeSimilarity`` (the sifarish distance job of resource/knn.sh)
  emits ``trainId, testId, distance, [trainClass, testClass]`` pair lines
  with int distances scaled by ``distance.scale``; with
  ``output.top.matches`` only the k nearest training rows per test row,
  selected on the card by kernel K3 (ops.topk) when the reference's gates
  allow, else by the sorted engine (ops.distance);
- ``FeatureCondProbJoiner`` joins the pair lines with the Naive Bayes
  ``output.feature.prob.only`` lines for class-conditional weighting;
- ``NearestNeighbor`` votes over the top-K neighbors per test row with
  ``Neighborhood``'s kernels and weights, in the reference's Java integer
  arithmetic (numpy on the host).

Parity notes carried over from the reference: the non-weighted
class-distribution output keeps its field separator, and the ``sigmoid``
kernel raises instead of leaving every neighborhood unscored.

Every job takes a ``device``; the distance job computes on it (or on the
mesh passed to its ``run``), and jobs with no device work still resolve
it, so that no entry point quietly runs on the CPU.  Not ported yet: tracing spans and the serving adapter
(``NearestNeighborAdapter``).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.config import JobConfig
from ..core.io import _input_files, read_lines, split_line, write_output
from ..core.metrics import ConfusionMatrix, CostBasedArbitrator, Counters
from ..core.obs import traced_run
from ..core.schema import FeatureSchema
from ..device import resolve_device
from ..ops.distance import pairwise_distances

KERNEL_SCALE = 100
PROB_SCALE = 100


# ---------------------------------------------------------------------------
# distance job (sifarish SameTypeSimilarity equivalent)
# ---------------------------------------------------------------------------

class SameTypeSimilarity:
    """Pairwise entity distances between a training and a test set (or a
    self-join), schema-driven.

    Config surface (resource/knn.properties:9-17): ``distance.scale``,
    ``inter.set.matching``, ``base.set.split.prefix`` (file-name prefix
    marking training-set files), plus ours: ``distance.algorithm``
    (euclidean|manhattan), ``include.class.attributes``,
    ``output.top.matches`` (emit only the k nearest per test entity via
    device top-k instead of all pairs)."""

    def __init__(self, config: JobConfig, schema: Optional[FeatureSchema] = None,
                 device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)

    def _encode(self, records: List[List[str]],
                vocabs: Dict[int, Dict[str, int]]):
        """Numeric columns range-normalized to [0,1] when min/max are
        declared; categorical columns to vocab codes.  ``vocabs`` is SHARED
        between the train and test encode calls so undeclared values get one
        consistent code across both sets."""
        num_cols, cat_cols = [], []
        num_w, cat_w = [], []
        for f in self.schema.feature_fields():
            w = float(f.extra.get("weight", 1.0))
            if f.is_categorical():
                vocab = vocabs.setdefault(
                    f.ordinal, {v: i for i, v in enumerate(f.cardinality or [])})
                col = np.asarray(
                    [vocab.setdefault(r[f.ordinal], len(vocab))
                     for r in records], dtype=np.int32)
                cat_cols.append(col)
                cat_w.append(w)
            else:
                col = np.asarray([float(r[f.ordinal]) for r in records])
                if f.min is not None and f.max is not None and f.max > f.min:
                    col = (col - f.min) / (f.max - f.min)
                num_cols.append(col)
                num_w.append(w)
        num = (np.stack(num_cols, axis=1) if num_cols
               else np.zeros((len(records), 0)))
        cat = (np.stack(cat_cols, axis=1) if cat_cols
               else np.zeros((len(records), 0), dtype=np.int32))
        return num, cat, np.asarray(num_w), np.asarray(cat_w)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        """The distance job; with ``mesh`` (``parallel.mesh.Mesh``) the
        distances run on that mesh instead of the job's device, with the
        same output bytes."""
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        inter_set = self.config.get_boolean("inter.set.matching", True)
        prefix = self.config.get("base.set.split.prefix", "tr")
        scale = self.config.get_int("distance.scale", 1000)
        algorithm = self.config.get("distance.algorithm", "euclidean")
        include_class = self.config.get_boolean("include.class.attributes",
                                                True)
        top_k = self.config.get_int("output.top.matches", None)
        # 'exact' (default) reproduces the secondary-sort ordering and
        # auto-selects the fused engine K3 on a CUDA device; the two exact
        # engines may differ by +/-1 int unit where a distance lands on
        # the int-scale rounding boundary (ops.distance.pairwise_distances);
        # 'fused'/'sorted' force one engine, 'approx' is answered exactly;
        # validated here so a typo fails loudly even on dense-output runs
        # where no selection runs
        topk_method = self.config.get("topk.method", "exact")
        if topk_method not in ("exact", "fused", "sorted", "approx"):
            raise ValueError(f"unknown top-k method {topk_method!r}; "
                             "use 'exact', 'fused', 'sorted' or 'approx'")

        train_recs: List[List[str]] = []
        test_recs: List[List[str]] = []
        for fp in _input_files(in_path):
            is_base = os.path.basename(fp).startswith(prefix)
            for line in read_lines(fp):
                rec = split_line(line, delim_regex)
                (train_recs if is_base or not inter_set else test_recs
                 ).append(rec)
        if not inter_set:
            test_recs = train_recs
        counters.set("Basic", "Training records", len(train_recs))
        counters.set("Basic", "Test records", len(test_recs))

        vocabs: Dict[int, Dict[str, int]] = {}
        tnum, tcat, num_w, cat_w = self._encode(train_recs, vocabs)
        qnum, qcat, _, _ = self._encode(test_recs, vocabs)

        id_field = self.schema.id_field()
        cls_field = None
        try:
            cls_field = self.schema.class_attr_field()
        except ValueError:
            include_class = False
        train_ids = [r[id_field.ordinal] for r in train_recs]
        test_ids = [r[id_field.ordinal] for r in test_recs]

        # self-join: request one extra neighbor so the zero-distance
        # diagonal entry does not consume a top-k slot
        effective_k = (top_k + 1 if top_k and not inter_set else top_k)
        stats: dict = {}
        dist, idx = pairwise_distances(
            qnum, qcat, tnum, tcat, num_w, cat_w, algorithm=algorithm,
            scale=scale, top_k=effective_k,
            device=None if mesh is not None else self.device,
            topk_method=topk_method, stats=stats, mesh=mesh)
        counters.set("Distance", "Fused engine calls",
                     int(stats["engine"] == "fused"))
        counters.set("Distance", "Re-resolved rows", stats["reresolved"])

        lines: List[str] = []
        for qi in range(len(test_recs)):
            cols = (idx[qi] if idx is not None
                    else range(len(train_recs)))
            emitted = 0
            for rank, ti in enumerate(cols):
                ti = int(ti)
                if not inter_set and ti == qi:
                    continue   # self-join skips the diagonal
                if top_k and emitted == top_k:
                    break
                d = int(dist[qi, rank] if idx is not None else dist[qi, ti])
                parts = [train_ids[ti], test_ids[qi], str(d)]
                if include_class and cls_field is not None:
                    parts.append(train_recs[ti][cls_field.ordinal])
                    parts.append(test_recs[qi][cls_field.ordinal])
                lines.append(delim.join(parts))
                emitted += 1
        counters.set("Basic", "Pairs emitted", len(lines))
        write_output(out_path, lines)
        return counters


# ---------------------------------------------------------------------------
# FeatureCondProbJoiner
# ---------------------------------------------------------------------------

class FeatureCondProbJoiner:
    """Joins distance pairs with NB feature-posterior lines
    (knn/FeatureCondProbJoiner.java).

    Prob lines are the BayesianPredictor's ``output.feature.prob.only``
    format: ``id, featPrior, class1, post1, class2, post2, actualClass``
    (BayesianPredictor.java output path); the joiner keeps, per training
    item, the posterior of its OWN class value
    (FeatureCondProbJoiner.java reducer first-tuple scan).  Output:
    ``testId, testClass, trainId, distance, trainClass, postProb`` — the
    exact column order NearestNeighbor's class-condition-weighted mapper
    expects (NearestNeighbor.java:137-149)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        # ``mesh`` is taken, as every job's run takes one, and not used:
        # this job runs on the host, as the reference's does
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        prefix = self.config.get("feature.cond.prob.split.prefix", "condProb")

        prob: Dict[str, Tuple[str, str]] = {}
        pair_lines: List[List[str]] = []
        for root in in_path.split(","):
            for fp in _input_files(root):
                is_prob = os.path.basename(fp).startswith(prefix)
                for line in read_lines(fp):
                    items = split_line(line, delim_regex)
                    if is_prob:
                        # id, featPrior, (class, post)*, actualClass
                        actual = items[-1]
                        post = ""
                        for i in range(2, len(items) - 1, 2):
                            if items[i] == actual:
                                post = items[i + 1]
                                break
                        prob[items[0]] = (actual, post)
                    else:
                        pair_lines.append(items)

        out: List[str] = []
        for items in pair_lines:
            train_id, test_id, dist = items[0], items[1], items[2]
            test_class = items[4] if len(items) > 4 else ""
            cls, post = prob.get(train_id, ("", ""))
            out.append(delim.join(
                [test_id, test_class, train_id, dist, cls, post]))
            counters.incr("Join", "Joined pairs")
        write_output(out_path, out)
        return counters


# ---------------------------------------------------------------------------
# Neighborhood (voting / kernel library)
# ---------------------------------------------------------------------------

class Neighborhood:
    """Vectorized Neighborhood (knn/Neighborhood.java): kernel scores for a
    whole [n_test, k] neighbor block at once; per-neighborhood reductions
    follow the reference's integer arithmetic."""

    CLASSIFICATION = "classification"
    REGRESSION = "regression"

    def __init__(self, kernel_function: str = "none", kernel_param: int = -1,
                 class_cond_weighted: bool = False,
                 inverse_distance_weighted: bool = False):
        self.kernel_function = kernel_function
        self.kernel_param = kernel_param
        self.class_cond_weighted = class_cond_weighted
        self.inverse_distance_weighted = inverse_distance_weighted

    def scores(self, distances: np.ndarray) -> np.ndarray:
        """Integer kernel score per neighbor (Neighborhood.java:126-160)."""
        d = distances.astype(np.int64)
        if self.kernel_function == "none":
            return np.ones_like(d)
        if self.kernel_function == "linearMultiplicative":
            return np.where(d == 0, 2 * KERNEL_SCALE,
                            KERNEL_SCALE // np.maximum(d, 1))
        if self.kernel_function == "linearAdditive":
            return KERNEL_SCALE - d
        if self.kernel_function == "gaussian":
            t = d.astype(np.float64) / self.kernel_param
            return (KERNEL_SCALE * np.exp(-0.5 * t * t)).astype(np.int64)
        raise ValueError(
            f"unsupported kernel function {self.kernel_function}")

    def weighted_scores(self, scores: np.ndarray, distances: np.ndarray,
                        post_probs: np.ndarray) -> np.ndarray:
        """Class-conditional weighting (Neighborhood.Neighbor.setScore,
        Neighborhood.java:52-66 of the inner class): score * postProb,
        optionally * 1/distance."""
        w = np.where(post_probs > 0, scores * post_probs,
                     scores.astype(np.float64))
        if self.inverse_distance_weighted:
            w = w / np.maximum(distances, 1e-12)
        return w


# ---------------------------------------------------------------------------
# NearestNeighbor classifier/regressor job
# ---------------------------------------------------------------------------

class NearestNeighbor:
    """Top-K voting job (knn/NearestNeighbor.java)."""

    def __init__(self, config: JobConfig, schema: Optional[FeatureSchema] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        c = config
        self.top_match_count = c.get_int("top.match.count", 10)
        self.validation = c.get_boolean("validation.mode", True)
        # the reference reads BOTH spellings: the mapper uses
        # "class.condition.weighted" (NearestNeighbor.java:121), the reducer
        # "class.condtion.weighted" (:239, matching knn.properties:37)
        ccw = c.get("class.condition.weighted", c.get("class.condtion.weighted"))
        self.class_cond_weighted = str(ccw).lower() == "true"
        self.prediction_mode = c.get("prediction.mode", "classification")
        self.regression_method = c.get("regression.method", "average")
        self.neighborhood = Neighborhood(
            c.get("kernel.function", "none"), c.get_int("kernel.param", -1),
            self.class_cond_weighted,
            c.get_boolean("inverse.distance.weighted", False))
        self.output_class_distr = c.get_boolean("output.class.distr", False)
        self.decision_threshold = c.get_float("decision.threshold", -1.0)
        self.use_cost_based = c.get_boolean("use.cost.based.classifier", False)
        self.pos_class = self.neg_class = None
        self.arbitrator = None
        if (self.decision_threshold > 0 or self.use_cost_based) \
                and self.prediction_mode == "classification":
            vals = c.must("class.attribute.values").split(",")
            self.pos_class, self.neg_class = vals[0], vals[1]
            if self.use_cost_based:
                cost = [int(v) for v in
                        c.must("misclassification.cost").split(",")]
                self.arbitrator = CostBasedArbitrator(
                    self.neg_class, self.pos_class, cost[1], cost[0])
        self.conf_matrix = None
        if self.validation and self.prediction_mode == "classification":
            schema = schema or FeatureSchema.from_file(
                c.must("feature.schema.file.path"))
            card = schema.class_attr_field().cardinality
            self.conf_matrix = ConfusionMatrix(card[0], card[1])

    # -- per-neighborhood decisions (Neighborhood.java:224-320) ----------
    @staticmethod
    def _distribution(class_vals: List[str],
                      scores: np.ndarray) -> Dict[str, float]:
        distr: Dict[str, float] = defaultdict(float)
        for cv, s in zip(class_vals, scores):
            distr[cv] += s
        return distr

    def _classify(self, distr: Dict[str, float]) -> str:
        if self.decision_threshold > 0 and not self.class_cond_weighted:
            pos = distr.get(self.pos_class, 0)
            neg = max((v for k, v in distr.items() if k != self.pos_class),
                      default=0)
            # neg == 0 -> pos/neg = Infinity in the reference
            # (Neighborhood.java:300), i.e. unanimous positive wins
            ratio = pos / neg if neg > 0 else float("inf")
            return (self.pos_class if ratio > self.decision_threshold
                    else self.neg_class)
        best, best_score = None, 0
        for cv, s in distr.items():
            if s > best_score:
                best, best_score = cv, s
        return best if best is not None else ""

    def _class_prob(self, distr: Dict[str, float], class_val: str) -> int:
        total = sum(distr.values())
        if total <= 0:
            return 0
        return int(distr.get(class_val, 0) * PROB_SCALE / total)

    def _regress(self, class_vals: List[str], regr_in: List[float],
                 test_regr_in: float) -> int:
        vals = [int(float(v)) for v in class_vals]
        if self.regression_method == "average":
            return int(sum(vals) / len(vals))   # int division parity
        if self.regression_method == "median":
            vals.sort()
            mid = len(vals) // 2
            return (vals[mid] if len(vals) % 2 == 1
                    else (vals[mid - 1] + vals[mid]) // 2)
        if self.regression_method == "linearRegression":
            x = np.asarray(regr_in, dtype=np.float64)
            yv = np.asarray([float(v) for v in class_vals])
            xm, ym = x.mean(), yv.mean()
            sxx = ((x - xm) ** 2).sum()
            slope = ((x - xm) * (yv - ym)).sum() / sxx if sxx > 0 else 0.0
            return int(ym + slope * (test_regr_in - xm))
        raise ValueError(
            f"unsupported regression method {self.regression_method}")

    def classify_group(self, neighbors: List[Tuple], test_id: str,
                       test_class_val: str = "",
                       test_regr_val: float = 0.0) -> Tuple[str, str]:
        """One neighborhood decision: ``neighbors`` are (dist, trainId,
        trainClass, postProb, regrIn) tuples in arrival order.  Returns
        (output line, predicted): the per-reducer-group body of ``run``."""
        delim = self.config.field_delim_out()
        ccw = self.class_cond_weighted
        neighbors = sorted(neighbors, key=lambda t: t[0])
        top = neighbors[:self.top_match_count]
        dists = np.asarray([t[0] for t in top])
        cvals = [t[2] for t in top]
        posts = np.asarray([t[3] for t in top])
        scores = self.neighborhood.scores(dists)
        if ccw:
            scores = self.neighborhood.weighted_scores(scores, dists, posts)

        distr = self._distribution(cvals, scores)
        parts = [test_id]
        if self.output_class_distr \
                and self.prediction_mode == "classification":
            for cv, s in distr.items():
                parts += [cv, str(s if ccw else int(s))]
        if self.validation:
            parts.append(test_class_val)

        if self.prediction_mode == "classification":
            if self.use_cost_based:
                pos_prob = self._class_prob(distr, self.pos_class)
                predicted = self.arbitrator.classify(pos_prob)
            else:
                predicted = self._classify(distr)
        else:
            predicted = str(self._regress(
                cvals, [t[4] for t in top], test_regr_val))
        parts.append(predicted)
        return delim.join(parts), predicted

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        # ``mesh`` is taken, as every job's run takes one, and not used:
        # this job runs on the host, as the reference's does
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        ccw = self.class_cond_weighted
        is_linreg = (self.prediction_mode == "regression"
                     and self.regression_method == "linearRegression")

        # mapper parse (NearestNeighbor.java:130-180)
        groups: Dict[str, List[Tuple]] = defaultdict(list)
        test_class: Dict[str, str] = {}
        test_regr: Dict[str, float] = {}
        for line in read_lines(in_path):
            items = split_line(line, delim_regex)
            if ccw:
                test_id, t_class, train_id = items[0], items[1], items[2]
                dist = int(items[3])
                train_class = items[4]
                post = float(items[5]) if items[5] else -1.0
                groups[test_id].append(
                    (dist, train_id, train_class, post, 0.0))
                test_class[test_id] = t_class
            else:
                train_id, test_id = items[0], items[1]
                dist = int(items[2])
                train_class = items[3]
                i = 4
                if self.validation:
                    test_class[test_id] = items[i]
                    i += 1
                r_in = 0.0
                if is_linreg:
                    r_in = float(items[i])
                    test_regr[test_id] = float(items[i + 1])
                groups[test_id].append(
                    (dist, train_id, train_class, -1.0, r_in))

        out: List[str] = []
        for test_id, neighbors in groups.items():
            line, predicted = self.classify_group(
                neighbors, test_id, test_class.get(test_id, ""),
                test_regr.get(test_id, 0.0))
            out.append(line)
            if self.conf_matrix is not None:
                self.conf_matrix.report(predicted,
                                        test_class.get(test_id, ""))
        if self.conf_matrix is not None:
            self.conf_matrix.to_counters(counters)
        write_output(out_path, out)
        return counters
