"""Per-model scorer adapters: the serving engine.

The port's counterpart of ``avenir_tpu/serve/engine.py``.  Each adapter
wraps one trained-artifact family's EXISTING predict path — the same
code the batch jobs run, so an online response is byte-identical to the
line the batch predictor would have written for the same row:

- ``naiveBayes``        — ``BayesianPredictor`` tables on the server's
  device + the f32 log-space (or f64 strict-parity) scorer, arbitration
  via ``emit_lines``.
- ``nearestNeighbor``   — the training set moved to the device once at
  load (``ops.distance.ResidentTraining``) + the fused distance + top-k
  kernel K3 feeding ``NearestNeighbor.classify_group`` voting.
- ``markovClassifier``  — ``MarkovModelClassifier``'s log-ratio table on
  the device + its gather and ordered log-odds sum, bucketed on rows and
  on sequence length.

- ``decisionTree``      — the tree builder's ``DecisionPathList``: each
  record routed to its first leaf path by one predicate matrix a batch
  (host NumPy, ``models.split``), as the reference's adapter (copied).
- ``banditDecision``    — ``decide`` requests of the streaming decision
  service: the arm chosen by Thompson sampling or UCB over the live
  ``stream.posterior.PosteriorStore`` that every replica shares.

An unknown kind is refused at load, never skipped.

Every adapter computes on one explicit ``torch.device`` (``cuda:0``
unless the caller asks for the CPU); a ``None`` device resolves to the
card and fails when there is none, so a replica never scores on the CPU
by default.  An adapter also takes the registry's ``mesh``: with several
positions the kNN adapter ranks through ``pairwise_distances(mesh=)`` and
the bandit adapter builds its store over the mesh; the others ignore it.

Batches are padded to the nearest power-of-two bucket so each scorer
sees a small fixed set of shapes.  PyTorch runs eagerly, so a "compile"
is the first build and call of a bucket's scorer
(``core.telemetry.profiled_build``): it brings up the context, loads the
kernels and fills the caching allocator at that shape.  Built scorers
live in a :class:`ScorerCompileCache` (the thread-safe bounded LRU of
``utils.caches``) whose MISS COUNT is exported as the ``Serve / Scorer
compilations`` counter — after warmup a steady-state request mix must not
move it.  A built scorer is a plain function of ``(x, values, *tables)``
with no buffers of its own, so replicas and same-shape tenants can call
one concurrently.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import sanitizer, telemetry
from ..core.config import JobConfig
from ..core.io import split_line
from ..core.metrics import Counters
from ..core.obs import get_tracer
from ..device import resolve_device
from ..utils.caches import bounded_cache_get, bounded_cache_put
from ..utils.graphs import GraphedCall

SERVE_GROUP = "Serve"

#: Built-in scorer VARIANT presets per adapter kind (INFaaS-style
#: model-less variants, PAPERS.md): naming a preset variant in
#: ``serve.model.<name>.variants`` applies its config overlay to the
#: model's scoring config and declares its latency/accuracy class —
#: ``f32`` is the fast log-space path, ``f64`` the strict-parity path.
#: Non-preset variant names declare their overlay explicitly via
#: ``serve.model.<name>.variant.<v>.<key>``.
VARIANT_PRESETS: Dict[str, Dict[str, dict]] = {
    "naiveBayes": {
        "f32": {"overlay": {"bp.score.precision": "float32"},
                "latency_class": "fast", "accuracy_class": "standard"},
        "f64": {"overlay": {"bp.score.precision": "float64"},
                "latency_class": "standard", "accuracy_class": "parity"},
    },
    "markovClassifier": {
        "f32": {"overlay": {"mmc.score.precision": "float32"},
                "latency_class": "fast", "accuracy_class": "standard"},
        "f64": {"overlay": {"mmc.score.precision": "float64"},
                "latency_class": "standard", "accuracy_class": "parity"},
    },
}


def pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= n (>= 1), optionally capped."""
    b = 1
    while b < n:
        b <<= 1
    if cap is not None and b > cap:
        b = cap
    return b


def pow2_buckets(cap: int) -> List[int]:
    """All power-of-two buckets up to and including ``pow2_bucket(cap)``."""
    out, b = [], 1
    top = pow2_bucket(cap)
    while b <= top:
        out.append(b)
        b <<= 1
    return out


class SharedCompileTier:
    """Process-shared compiled-scorer cache keyed by SHAPE SIGNATURE —
    the multi-tenant compile-reuse tier (INFaaS/TF-Serving, PAPERS.md;
    README "Multi-tenant model multiplexing").

    Adapters key their built scorers by everything a build actually
    depends on — score-function identity, padded bucket, and
    the model tables' shapes/dtypes — NOT by adapter identity, so 1,000
    same-schema NB tenants resolve to ONE compiled fold: the first
    tenant's warmup compiles it, every later tenant's warmup and traffic
    hit.  Steady-state ``Serve / Scorer compilations`` across a tenant
    fleet therefore stays flat (asserted in tests/test_modelcache.py).

    Concurrency: lookups are SINGLE-FLIGHT — N promote workers racing
    the same signature block on one build instead of compiling N times
    (per-key build events; a failed build wakes the waiters and the
    next caller retries as the builder).  Eviction (bounded LRU, ``cap``
    signatures) only drops the tier's reference: an in-flight score
    holding the compiled fn keeps it alive, and a re-request simply
    recompiles.  ``compiles + hits`` always equals total resolved gets
    (the consistency the hammer test asserts)."""

    def __init__(self, cap: int = 256):
        self.cap = max(1, int(cap))
        self._lock = sanitizer.make_lock("serve.compile.tier")
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._building: Dict[tuple, threading.Event] = {}
        self.compiles = 0
        self.hits = 0
        self.waits = 0

    def get(self, key, build: Callable[[], object]):
        """Resolve ``key`` to its compiled fn, building at most once per
        key concurrently; returns ``(fn, compiled)`` where ``compiled``
        says THIS call did the build."""
        while True:
            ev = None
            with self._lock:
                fn = self._cache.get(key)
                if fn is not None:
                    self._cache.move_to_end(key)
                    self.hits += 1
                    return fn, False
                ev = self._building.get(key)
                if ev is None:
                    ev = self._building[key] = threading.Event()
                    break
                self.waits += 1
            ev.wait()
        try:
            fn = build()
        except BaseException:
            # waiters retry; the next one becomes the builder
            with self._lock:
                self._building.pop(key, None)
            ev.set()
            raise
        with self._lock:
            self._cache[key] = fn
            self._cache.move_to_end(key)
            while len(self._cache) > self.cap:
                self._cache.popitem(last=False)
            self.compiles += 1
            self._building.pop(key, None)
        ev.set()
        return fn, True

    def size(self) -> int:
        with self._lock:
            return len(self._cache)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._cache), "cap": self.cap,
                    "compiles": self.compiles, "hits": self.hits,
                    "waits": self.waits}


_SHARED_TIER = SharedCompileTier()


def get_shared_tier() -> SharedCompileTier:
    """The one process-wide compile tier (multi-tenant serving shares
    compiled scorers across every registry/pool in the process)."""
    return _SHARED_TIER


class ScorerCompileCache:
    """Bounded LRU of compiled scorer functions with hit/miss counters.

    A miss means a scorer was (re)built — its first call brings up the
    device work at that shape — so ``Serve / Scorer compilations`` counts
    real build work.  Keys include the padded bucket shape, so a warmed
    bucket never recompiles until evicted (cap is sized above the bucket
    count to make steady-state eviction impossible).

    With ``tier`` set (multi-tenant cache mode; serve/modelcache.py)
    lookups delegate to the process-shared :class:`SharedCompileTier`:
    the per-model counters then bill only the compiles THIS model
    caused — a tenant whose shapes another tenant already compiled
    records hits, not compilations."""

    def __init__(self, counters: Counters, cap: int = 32,
                 tier: Optional[SharedCompileTier] = None):
        self._cache: dict = {}
        self._counters = counters
        self._cap = cap
        self._tier = tier

    def get(self, key, build: Callable[[], object]):
        if self._tier is not None:
            fn, compiled = self._tier.get(key, build)
            self._counters.incr(
                SERVE_GROUP,
                "Scorer compilations" if compiled else "Scorer cache hits")
            return fn
        fn = bounded_cache_get(self._cache, key)
        if fn is None:
            fn = build()
            self._counters.incr(SERVE_GROUP, "Scorer compilations")
            bounded_cache_put(self._cache, key, fn, cap=self._cap)
        else:
            self._counters.incr(SERVE_GROUP, "Scorer cache hits")
        return fn

    def compilations(self) -> int:
        return self._counters.get(SERVE_GROUP, "Scorer compilations")


class ModelAdapter:
    """Uniform adapter surface the registry/batcher drive.

    ``predict_lines`` maps N request lines to N results positionally; a
    ``None`` result marks a per-row failure (e.g. a record too short to
    score) that the frontend turns into an error response without failing
    the rest of the batch."""

    KIND = "?"

    def __init__(self, config: JobConfig, counters: Counters,
                 cache: Optional[ScorerCompileCache] = None,
                 max_bucket: int = 64, device=None, mesh=None):
        self.config = config
        self.counters = counters
        self.cache = cache or ScorerCompileCache(counters)
        self.max_bucket = pow2_bucket(max_bucket)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.delim_regex = config.field_delim_regex()
        self.delim = config.field_delim_out()

    # -- surface -----------------------------------------------------------
    def predict_lines(self, lines: List[str]) -> List[Optional[str]]:
        raise NotImplementedError

    def warm(self, bucket: int) -> None:
        """Build and run the scorer once at one batch bucket (no-op by
        default)."""

    def device_bytes(self) -> int:
        """Approximate bytes of device-resident model state this adapter
        pins (tables, training matrices) — what the multi-tenant model
        cache accounts against ``serve.cache.hbm.budget.bytes``.  The
        cache applies a per-replica floor so residency is never free."""
        return 0

    # -- shared helpers ----------------------------------------------------
    def _bucket(self, n: int) -> int:
        b = pow2_bucket(n, self.max_bucket)
        self.counters.incr(SERVE_GROUP, "Padded rows", b)
        # pad fraction: wasted slots in this scoring batch (0 = perfectly
        # full bucket) — a Chrome-trace counter series when tracing is on
        get_tracer().gauge("serve.pad.fraction", 1.0 - n / b)
        return b

    def _split(self, lines: List[str]) -> List[List[str]]:
        return [split_line(l, self.delim_regex) for l in lines]


def _require_declared_schema(schema) -> None:
    """Serving pins scorer-table extents at load time, so every feature
    extent must be declared in the schema: categorical cardinality lists,
    and non-negative [min, max] ranges for bucketed numerics.  (The batch
    predictor re-derives extents per input file; an online model cannot.)"""
    for f in schema.feature_fields():
        if f.is_categorical():
            if not f.cardinality:
                raise ValueError(
                    f"serving requires declared cardinality for categorical "
                    f"feature '{f.name}' (ordinal {f.ordinal})")
        elif f.is_bucket_width_defined():
            if f.max is None or f.min is None or f.min < 0:
                raise ValueError(
                    f"serving requires declared 0 <= min <= max for bucketed "
                    f"feature '{f.name}' (ordinal {f.ordinal})")


# ---------------------------------------------------------------------------
# Naive Bayes
# ---------------------------------------------------------------------------

class NaiveBayesAdapter(ModelAdapter):
    """Wraps ``BayesianPredictor``: probability tables are built ONCE from
    the declared schema extents and live on the adapter's device; per
    batch only the padded int32 ``x`` and float64 ``values`` move.  The
    scorer is the batch job's own ``_score_batch_f32`` (its tables
    prepared once, at load) or ``_score_batch`` (``bp.score.precision``),
    with XLA's float math (ops.xla_math) and no TF32.  Table shapes equal
    what the batch predictor derives for any in-domain input, so responses are
    byte-identical to the batch job's output lines; out-of-domain rows
    (out-of-vocabulary categorical value, numeric past the declared range
    or negative) are rejected per-row instead of silently mis-binning."""

    KIND = "naiveBayes"

    def __init__(self, config: JobConfig, counters: Counters, **kw):
        super().__init__(config, counters, **kw)
        from ..convert import predictor_tables_to_device
        from ..core.binning import DatasetEncoder
        from ..models.bayesian import BayesianPredictor

        self.predictor = BayesianPredictor(config, device=self.device)
        schema = self.predictor.schema
        _require_declared_schema(schema)
        self.encoder = DatasetEncoder(schema)
        ds0 = self.encoder.encode([])
        host = predictor_tables_to_device(
            self.predictor._build_tables(ds0), "cpu")
        self._num_bins = np.asarray(ds0.num_bins, np.int64)
        self._binned = np.asarray(ds0.binned_mask, bool)
        # the float32 scorer's logs of the tables are taken once a model,
        # on the host (the same bits as on a card), and not per batch
        # (and its feature probabilities only where they are printed)
        self._score_kw = {}
        if self.predictor.score_precision == "float32":
            self._score_fn = BayesianPredictor._score_prepared_f32
            host = BayesianPredictor._prepare_f32(*host)
            self._score_kw = {
                "feat": self.predictor.output_feature_prob_only}
        else:
            self._score_fn = BayesianPredictor._score_batch
        self._tables = tuple(t.to(self.device) for t in host)
        self._F = len(self.encoder.feature_fields)
        self._cls_ord = schema.class_attr_field().ordinal
        self._min_fields = max(
            [f.ordinal for f in self.encoder.feature_fields]
            + [self._cls_ord]) + 1
        # shape signature: everything a built scorer depends on — the
        # score fn, the padded row width, and the table shapes/dtypes.
        # Same-schema tenants share it, so the process-shared compile
        # tier resolves all of them to ONE built scorer per bucket.
        self._shape_sig = (
            self._score_fn.__name__, self._F,
            tuple((tuple(t.shape), str(t.dtype)) for t in self._tables))

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The device-resident tables (what ``device_bytes`` counts)."""
        return self._tables

    def device_bytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for t in self._tables)

    def _compiled(self, bucket: int):
        # profiled_build: the (warmup or first-traffic) first call of each
        # bucket's scorer lands in the xla.compile.ms telemetry counter;
        # on a card the scorer is a CUDA graph a bucket (its ~85 launches
        # for a float32 row replayed as one), shared like a built scorer
        def build():
            fn = self._score_fn
            if self.device.type == "cuda":
                fn = GraphedCall(fn, self.device)
            return telemetry.profiled_build(fn, f"serve.nb.score.b{bucket}")
        return self.cache.get(
            ("nb", self._shape_sig, bucket, str(self.device)), build)

    def _score(self, x: np.ndarray, v: np.ndarray):
        """The scorer's outputs on the host (a graph takes its inputs from
        the host itself)."""
        out = self._compiled(x.shape[0])(
            torch.from_numpy(x), torch.from_numpy(v), *self._tables,
            **self._score_kw)
        return tuple(None if t is None else t.cpu() for t in out)

    def warm(self, bucket: int) -> None:
        self._score(np.zeros((bucket, self._F), np.int32),
                    np.zeros((bucket, self._F), np.float64))

    def predict_lines(self, lines: List[str]) -> List[Optional[str]]:
        records = self._split(lines)
        ok = [i for i, r in enumerate(records) if len(r) >= self._min_fields]
        results: List[Optional[str]] = [None] * len(lines)
        if not ok:
            return results
        recs = [records[i] for i in ok]
        try:
            ds = self.encoder.encode(recs)
        except ValueError:
            return self._predict_rowwise_encode(lines, records, ok, results)
        xm, bad = self._domain_check(ds)
        if bad.any():
            keep = [i for i, b in zip(ok, bad) if not b]
            recs = [records[i] for i in keep]
            if not recs:
                return results
            ds = self.encoder.encode(recs)   # clean re-encode, no shift
            xm = ds.x
            ok = keep
        n = len(recs)
        b = self._bucket(n)
        x = np.zeros((b, self._F), np.int32)
        v = np.zeros((b, self._F), np.float64)
        x[:n] = xm
        v[:n] = ds.values
        probs, feat_prior, feat_post = (
            None if t is None else t.numpy()[:n] for t in self._score(x, v))
        actuals = [r[self._cls_ord] for r in recs]
        out = self.predictor.emit_lines(
            [lines[i] for i in ok], recs, actuals, probs, feat_prior,
            feat_post, self.delim, self.counters, with_confusion=False)
        for j, i in enumerate(ok):
            results[i] = out[j]
        return results

    def _domain_check(self, ds) -> Tuple[np.ndarray, np.ndarray]:
        """Undo any negative-bin shift and flag out-of-domain rows: the
        load-time tables cover exactly the declared extents, so a row
        whose bin falls outside them must be rejected, not clipped into a
        neighboring (wrong) bin."""
        x = ds.x
        bad = np.zeros(x.shape[0], bool)
        if ds.bin_offset.any():
            x = x + ds.bin_offset[None, :]       # restore original bins
            bad |= ((x < 0) & self._binned[None, :]).any(axis=1)
        over = (x >= self._num_bins[None, :]) & self._binned[None, :]
        bad |= over.any(axis=1)
        return x, bad

    def _predict_rowwise_encode(self, lines, records, ok, results):
        """Per-row fallback when a record's numeric field fails to parse."""
        for i in ok:
            try:
                self.encoder.encode([records[i]])
            except ValueError:
                continue
            row_out = self.predict_lines([lines[i]])
            results[i] = row_out[0]
        return results


# ---------------------------------------------------------------------------
# kNN (fused distance + Neighborhood voting)
# ---------------------------------------------------------------------------

class NearestNeighborAdapter(ModelAdapter):
    """Training set encoded once at load and moved to the adapter's
    device once (``ops.distance.ResidentTraining``, the resident
    "model"); per batch only the padded queries move, kernel K3 ranks
    them (``ops.topk.k3_applicable`` on the card) and
    ``NearestNeighbor.classify_group`` votes — the same two-job batch
    pipeline (SameTypeSimilarity + NearestNeighbor) collapsed in memory.

    Extra config key: ``train.data.path`` (the training CSV the distance
    job would have read as its base split)."""

    KIND = "nearestNeighbor"

    def __init__(self, config: JobConfig, counters: Counters, **kw):
        super().__init__(config, counters, **kw)
        from ..core.io import read_lines
        from ..models.knn import NearestNeighbor, SameTypeSimilarity
        from ..ops.distance import ResidentTraining

        self.sts = SameTypeSimilarity(config, device=self.device)
        self.nn = NearestNeighbor(config, schema=self.sts.schema,
                                  device=self.device)
        if self.nn.class_cond_weighted:
            raise ValueError("serving kNN does not support "
                             "class-condition-weighted mode (it needs the "
                             "offline FeatureCondProbJoiner leg)")
        train_path = config.must("train.data.path")
        train_recs = [split_line(l, self.delim_regex)
                      for l in read_lines(train_path)]
        if not train_recs:
            raise ValueError(f"empty kNN training set: {train_path}")
        self.vocabs: Dict[int, Dict[str, int]] = {}
        tnum, tcat, num_w, cat_w = self.sts._encode(train_recs, self.vocabs)
        schema = self.sts.schema
        id_field = schema.id_field()
        self.id_ord = id_field.ordinal if id_field is not None else 0
        cls_field = schema.class_attr_field()
        self.cls_ord = cls_field.ordinal
        self.train_ids = [r[self.id_ord] for r in train_recs]
        self.train_class = [r[self.cls_ord] for r in train_recs]
        self.scale = config.get_int("distance.scale", 1000)
        self.algorithm = config.get("distance.algorithm", "euclidean")
        self.topk_method = config.get("topk.method", "exact")
        self.top_k = self.nn.top_match_count
        self.train = ResidentTraining(tnum, tcat, num_w, cat_w,
                                      self.algorithm, self.device)
        self._min_fields = max(
            [self.id_ord, self.cls_ord]
            + [f.ordinal for f in schema.feature_fields()]) + 1

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The device-resident training tensors (what ``device_bytes``
        counts)."""
        return (self.train.tn, self.train.tc, self.train.wc)

    def device_bytes(self) -> int:
        return self.train.nbytes()

    def _distances(self, qnum, qcat):
        from ..ops.distance import pairwise_distances, resident_distances

        # count a "compilation" per first-seen padded query shape (the
        # queries pad to the mesh's position count), keyed by the
        # TRAINING-set shape signature (not adapter identity), as the
        # reference does for its shape-keyed distance compiles
        d = self.mesh.size if self.mesh is not None else 1
        self.cache.get(
            ("knn-shape", tuple(self.train.tnum.shape),
             tuple(self.train.tcat.shape), self.top_k, self.algorithm,
             self.scale, self.topk_method, -(-qnum.shape[0] // d) * d),
            lambda: True)
        if d > 1:
            t = self.train
            return pairwise_distances(
                qnum, qcat, t.tnum, t.tcat, t.num_weights, t.cat_weights,
                algorithm=self.algorithm, scale=self.scale,
                top_k=self.top_k, mesh=self.mesh,
                topk_method=self.topk_method)
        return resident_distances(
            qnum, qcat, self.train, scale=self.scale, top_k=self.top_k,
            topk_method=self.topk_method)

    def warm(self, bucket: int) -> None:
        qnum = np.zeros((bucket, self.train.tnum.shape[1]))
        qcat = np.zeros((bucket, self.train.tcat.shape[1]), np.int32)
        self._distances(qnum, qcat)

    def predict_lines(self, lines: List[str]) -> List[Optional[str]]:
        records = self._split(lines)
        ok = [i for i, r in enumerate(records)
              if len(r) >= self._min_fields]
        results: List[Optional[str]] = [None] * len(lines)
        if not ok:
            return results
        recs = [records[i] for i in ok]
        try:
            qnum, qcat, _, _ = self.sts._encode(recs, self.vocabs)
        except ValueError:
            return results
        n = len(recs)
        b = self._bucket(n)
        if b > n:
            qnum = np.concatenate(
                [qnum, np.zeros((b - n, qnum.shape[1]))], axis=0)
            qcat = np.concatenate(
                [qcat, np.zeros((b - n, qcat.shape[1]), qcat.dtype)], axis=0)
        dist, idx = self._distances(qnum, qcat)
        for j, i in enumerate(ok):
            neighbors = []
            for rank in range(idx.shape[1]):
                ti = int(idx[j, rank])
                neighbors.append((int(dist[j, rank]), self.train_ids[ti],
                                  self.train_class[ti], -1.0, 0.0))
            test_class = recs[j][self.cls_ord] if self.nn.validation else ""
            line, _ = self.nn.classify_group(
                neighbors, recs[j][self.id_ord], test_class)
            results[i] = line
        return results


# ---------------------------------------------------------------------------
# Markov log-odds classifier
# ---------------------------------------------------------------------------

class MarkovClassifierAdapter(ModelAdapter):
    """Wraps ``MarkovModelClassifier``: its log-ratio table lives on the
    adapter's device, and the scorer (the batch job's own
    ``_mmc_pair_log_odds``, a CUDA graph a bucket pair on a card) is
    bucketed on both axes: rows by powers of two, sequence lengths by the
    ``seq.buckets`` config list (default "16,64") with power-of-two
    fallback above the largest.  The ordered log-odds sum makes the
    padding invisible, so each response is the batch classifier's line
    byte for byte."""

    KIND = "markovClassifier"

    def __init__(self, config: JobConfig, counters: Counters, **kw):
        super().__init__(config, counters, **kw)
        from ..models.markov import MarkovModelClassifier

        self.classifier = MarkovModelClassifier(config, device=self.device)
        self.classifier._prepare()
        self.seq_buckets = sorted({
            int(v) for v in
            (config.get("seq.buckets", "16,64")).split(",")})
        # shape signature (see NaiveBayesAdapter): the table's shape and
        # dtype, so same-state-space tenants share one built scorer per
        # (row, length) bucket pair
        self._shape_sig = tuple((tuple(t.shape), str(t.dtype))
                                for t in self.tensors())

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The device-resident log-ratio table (what ``device_bytes``
        counts)."""
        return self.classifier.tables()

    def device_bytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for t in self.tensors())

    def _len_bucket(self, length: int) -> int:
        for b in self.seq_buckets:
            if length <= b:
                return b
        return pow2_bucket(length)

    def _compiled(self, bucket: int, len_bucket: int):
        # the reference's compiled program a (row, length) bucket pair: on
        # a card a CUDA graph (the gather and the ordered sum's one add a
        # pair column replayed as one launch), built through
        # profiled_build and shared like the NB scorer; eager on the CPU
        def build():
            from ..models.markov import _mmc_pair_log_odds
            fn = _mmc_pair_log_odds
            if self.device.type == "cuda":
                fn = GraphedCall(fn, self.device)
            return telemetry.profiled_build(
                fn, f"serve.markov.score.b{bucket}.l{len_bucket}")
        return self.cache.get(
            ("markov", self._shape_sig, bucket, len_bucket,
             str(self.device)), build)

    def warm(self, bucket: int) -> None:
        for lb in self.seq_buckets:
            frm = torch.full((bucket, lb - 1), -1, dtype=torch.int32)
            valid = torch.zeros((bucket, lb - 1), dtype=torch.bool)
            self._compiled(bucket, lb)(frm, frm, valid, *self.tensors())

    def predict_lines(self, lines: List[str]) -> List[Optional[str]]:
        clf = self.classifier
        records = self._split(lines)
        ok = [i for i, r in enumerate(records)
              if len(r) >= clf.min_fields()
              and all(s in clf.model.index for s in r[clf.skip:])
              and (not clf.validation or len(r) > clf.class_ord)]
        results: List[Optional[str]] = [None] * len(lines)
        if not ok:
            return results
        recs = [records[i] for i in ok]
        n = len(recs)
        b = self._bucket(n)
        lmax = max(len(r) - clf.skip for r in recs)
        lb = self._len_bucket(lmax)
        out = clf.classify_records(
            recs, self.counters, score_fn=self._compiled(b, lb),
            pad_rows_to=b, pad_len_to=lb)
        for j, i in enumerate(ok):
            results[i] = out[j]
        return results


# ---------------------------------------------------------------------------
# Decision-path (tree) evaluation
# ---------------------------------------------------------------------------

class DecisionTreeAdapter(ModelAdapter):
    """Routes each record down the trained ``DecisionPathList`` (the tree
    builder's JSON checkpoint): a record's response is the first leaf path
    whose every predicate it satisfies — ``id, pathStr, population,
    infoContent`` — evaluated as one vectorized predicate matrix per batch
    (host NumPy; decision paths are tiny, so this path never compiles)."""

    KIND = "decisionTree"

    def __init__(self, config: JobConfig, counters: Counters, **kw):
        super().__init__(config, counters, **kw)
        from ..core.schema import FeatureSchema
        from ..models.split import AttributePredicate
        from ..models.tree import ROOT_PATH, DecisionPathList

        self.schema = FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.dpl = DecisionPathList.from_file(
            config.must("decision.file.path"))
        if not self.dpl.paths:
            raise ValueError("decision path list is empty")
        self.id_ord = (self.schema.id_field().ordinal
                       if self.schema.id_field() is not None else 0)
        # unique predicates across all leaves -> one evaluation column each
        self._pred_index: Dict[str, int] = {}
        self._preds = []
        self._leaf_pred_cols: List[List[int]] = []
        for p in self.dpl.paths:
            cols = []
            for ps in p.predicate_strs:
                if ps == ROOT_PATH:
                    continue
                k = self._pred_index.get(ps)
                if k is None:
                    k = len(self._preds)
                    self._pred_index[ps] = k
                    attr = int(ps.split()[0])
                    self._preds.append(AttributePredicate.parse(
                        ps, self.schema.field_by_ordinal(attr)))
                cols.append(k)
            self._leaf_pred_cols.append(cols)
        self._attrs = sorted({p.attr for p in self._preds})
        self._min_fields = max(
            [self.id_ord] + [p.attr for p in self._preds]) + 1

    def predict_lines(self, lines: List[str]) -> List[Optional[str]]:
        from ..models.split import predicate_matrix
        from ..models.tree import _column

        records = self._split(lines)
        ok = [i for i, r in enumerate(records)
              if len(r) >= self._min_fields]
        results: List[Optional[str]] = [None] * len(lines)
        if not ok:
            return results
        recs = [records[i] for i in ok]
        try:
            col_by_attr = {a: _column(recs, self.schema.field_by_ordinal(a))
                           for a in self._attrs}
        except ValueError:
            return self._predict_rowwise(lines, records, ok, results)
        bmat = predicate_matrix(self._preds, col_by_attr)
        for j, i in enumerate(ok):
            results[i] = self._route(recs[j], bmat[j])
        return results

    def _predict_rowwise(self, lines, records, ok, results):
        """Per-row fallback when one record's numeric field fails to parse
        (so one malformed row cannot fail its whole micro-batch)."""
        from ..models.split import predicate_matrix
        from ..models.tree import _column

        for i in ok:
            rec = records[i]
            try:
                col_by_attr = {
                    a: _column([rec], self.schema.field_by_ordinal(a))
                    for a in self._attrs}
            except ValueError:
                continue
            bmat = predicate_matrix(self._preds, col_by_attr)
            results[i] = self._route(rec, bmat[0])
        return results

    def _route(self, rec: List[str], brow: np.ndarray) -> Optional[str]:
        for leaf, cols in zip(self.dpl.paths, self._leaf_pred_cols):
            if all(brow[k] for k in cols):
                return self.delim.join(
                    [rec[self.id_ord], leaf.path_str, str(leaf.population),
                     repr(leaf.info_content)])
        return None


# ---------------------------------------------------------------------------
# streaming bandit decisions (stream.posterior)
# ---------------------------------------------------------------------------

class BanditDecisionAdapter(ModelAdapter):
    """Serves ``decide`` requests for the streaming decision service:
    request lines are ``eventID,tenant``, responses ``eventID,tenant,arm``,
    the arm chosen by Thompson sampling or UCB over the tenant's per-arm
    posterior.

    The posterior is the live :class:`~avenir_tpu_torch.stream.posterior.
    PosteriorStore` named by ``stream.store``: every replica's adapter
    resolves to the same store (built from this model's manifest on the
    adapter's device when not registered yet), so the feedback consumer's
    folds reach every replica at once.  Decisions are pure functions of
    (posterior, ``stream.seed``, event id), so responses do not depend on
    batching, replica or restarts.  Unknown tenants and short rows fail
    per row (a ``None`` result), never scored against another tenant."""

    KIND = "banditDecision"

    def __init__(self, config: JobConfig, counters: Counters, **kw):
        super().__init__(config, counters, **kw)
        from ..stream.posterior import ensure_store, event_crc

        self.store = ensure_store(config, device=self.device,
                                  mesh=self.mesh)
        self._crc = event_crc
        self._min_fields = 2
        if self.device.type == "cuda":
            # capture the decide graphs of every bucket before serving
            self.store.prepare_decide(pow2_buckets(self.max_bucket))

    def warm(self, bucket: int) -> None:
        self.store.decide(np.zeros(bucket, np.int32),
                          np.zeros(bucket, np.uint32))

    def predict_lines(self, lines: List[str]) -> List[Optional[str]]:
        records = self._split(lines)
        index = self.store.tenant_index
        ok = [i for i, r in enumerate(records)
              if len(r) >= self._min_fields and r[1] in index]
        results: List[Optional[str]] = [None] * len(lines)
        if not ok:
            return results
        n = len(ok)
        b = self._bucket(n)
        tid = np.zeros(b, np.int32)
        crc = np.zeros(b, np.uint32)
        for j, i in enumerate(ok):
            tid[j] = index[records[i][1]]
            crc[j] = self._crc(records[i][0])
        sels = self.store.decide(tid, crc)
        arms = self.store.arms
        for j, i in enumerate(ok):
            r = records[i]
            results[i] = (f"{r[0]}{self.delim}{r[1]}{self.delim}"
                          f"{arms[int(sels[j])]}")
            self.counters.incr(SERVE_GROUP, "Decisions")
        return results


ADAPTER_KINDS: Dict[str, type] = {
    cls.KIND: cls for cls in (NaiveBayesAdapter, NearestNeighborAdapter,
                              MarkovClassifierAdapter, DecisionTreeAdapter,
                              BanditDecisionAdapter)}


def adapter_class(kind: str) -> type:
    """The adapter class of ``kind``; an unknown kind raises, naming it,
    so no configured model is ever skipped."""
    cls = ADAPTER_KINDS.get(kind)
    if cls is not None:
        return cls
    raise ValueError(f"unknown model kind {kind!r}; known: "
                     + ", ".join(sorted(ADAPTER_KINDS)))
