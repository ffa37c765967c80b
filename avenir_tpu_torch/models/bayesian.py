"""Naive Bayes: distribution trainer + batch predictor on one CUDA card.

The port's counterpart of ``avenir_tpu/models/bayesian.py`` (tabular
mode).  The model text format and every output byte are the reference's:

- ``BayesianDistribution`` bins each record's features once in ingest
  (core.binning), folds the class x feature x bin count table on the
  device with kernel K1 (ops.histogram) chunk by chunk, accumulates exact
  Gaussian moments of the unbinned columns on the host in float64, and
  writes the model as delimited text;
- ``BayesianPredictor`` loads that text, builds per-class lookup tables
  on the host, and scores the batch on the device as a gather plus
  products (float64, the strict-parity path) or a log-space sum
  (float32, the default), then arbitrates and writes one line per record.

With ``ingest.cache.enable`` the first streamed training scan also
writes the parse-once ingest cache (core.ingestcache), and later runs
replay its mmapped matrices instead of parsing; the warm fold bins inside
the count with kernel K2 (``ops.counting.feature_class_counts_rawbin``).

Float32 matrix products never run here: the bin pick is a gather, which
is exact, so TF32 cannot round it.  The float64 factors use XLA's float64
``exp`` and the float32 log-space sums XLA's float32 ``log`` and its
contracted multiply-adds (ops.xla_math), so the feature probabilities
that ``output.feature.prob.only`` prints are the reference's bits.  Not
ported yet: text mode (``tabular.input=false``), checkpoint/resume, row
quarantine, the shared-scan FoldSpec, drift gauges and tracing spans.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.binning import DatasetEncoder, EncodedDataset
from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import ConfusionMatrix, CostBasedArbitrator, Counters
from ..core.schema import FeatureSchema
from ..convert import predictor_tables_to_device
from ..device import resolve_device
from ..ops.counting import (feature_class_counts,
                            feature_class_counts_rawbin, sharded_reduce)
from ..ops.xla_math import exp_f64, fma_f32, log_f32

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _java_int32(x: torch.Tensor) -> torch.Tensor:
    """Java ``(int)`` cast of a float tensor: NaN maps to 0, out-of-range
    values saturate at Integer.MIN/MAX_VALUE, in-range values truncate
    toward zero (a plain cast of NaN or out-of-range floats is
    undefined)."""
    # the largest value of the dtype <= 2^31-1 (float32 rounds 2147483647
    # up to 2^31, which would overflow the cast); values above it pin to
    # Integer.MAX_VALUE
    hi = 2147483520.0 if x.dtype == torch.float32 else 2147483647.0
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                device=x.device), x)
    out = x.clamp(-2147483648.0, hi).to(torch.int32)
    return torch.where(x > hi, torch.full_like(out, 2 ** 31 - 1), out)


def _java_int32_np(x):
    """NumPy twin of ``_java_int32`` (float64 only)."""
    x = np.where(np.isnan(x), 0.0, x)
    return np.clip(x, -2147483648.0, 2147483647.0).astype(np.int32)


def _jdiv(a: int, b: int) -> int:
    """Java long division: truncates toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _jstd(vsq: int, cnt: int, mean: int) -> int:
    """The reference's standard deviation,
    ``(long)Math.sqrt((valSqSum - count*mean*mean)/(count-1))``; Java's
    sqrt of a negative is NaN and ``(long)NaN == 0``."""
    if cnt <= 1:
        return 0
    t = (vsq - cnt * mean * mean) / (cnt - 1)
    return int(math.sqrt(t)) if t > 0 else 0


def _prod_last(t: torch.Tensor) -> torch.Tensor:
    """Product over the last axis, left to right: a fixed order, so the
    float64 products round the same way on every device."""
    p = t[..., 0]
    for k in range(1, t.shape[-1]):
        p = p * t[..., k]
    return p


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    s = t[..., 0]
    for k in range(1, t.shape[-1]):
        s = s + t[..., k]
    return s


def _nb_local(x, y, mask, n_class, max_bins, out=None):
    """The fold's ``local_fn``: one chunk's count table, added into
    ``out`` when given."""
    return feature_class_counts(x, y, n_class, max_bins, mask=mask, out=out)


def _nb_local_rawbin(x, y, mask, n_class, max_bins, widths, out=None):
    """The warm ingest-cache fold: ``x`` holds the cache's pre-bin raw
    integers, binned inside the count (kernel K2 on the card)."""
    return feature_class_counts_rawbin(x, y, n_class, max_bins, widths,
                                       mask=mask, out=out)


def rawbin_widths(enc: DatasetEncoder) -> Tuple[int, ...]:
    """Per feature column, the divisor that turns the ingest cache's raw
    integer into its bin: the bucket width, 1 for categorical codes (and
    for continuous columns, whose raw entries are -1)."""
    return tuple(int(f.bucketWidth) if f.is_bucket_width_defined() else 1
                 for f in enc.feature_fields)


def _host_moments(values: np.ndarray, y: np.ndarray, n_class: int,
                  cont_cols) -> Dict[int, np.ndarray]:
    """Exact per-class ``(count, sum, sumsq)`` of each unbinned column, in
    float64 on the host (the moments are integer-valued, so any summation
    order is exact)."""
    out = {}
    if not cont_cols:
        return out
    cont_cols = tuple(cont_cols)
    if n_class == 0:
        return {j: np.zeros((3, 0)) for j in cont_cols}
    n = len(y)
    if n_class > 16 or n * n_class * 8 > (1 << 28):
        cnt = np.bincount(y, minlength=n_class)[:n_class]
        for j in cont_cols:
            v = np.ascontiguousarray(values[:, j])
            s = np.bincount(y, weights=v, minlength=n_class)[:n_class]
            s2 = np.bincount(y, weights=v * v, minlength=n_class)[:n_class]
            out[j] = np.stack([cnt, s, s2])
        return out
    # per-class sums as matrix-vector products against a class-indicator
    # matrix: faster than a weighted bincount per column
    M = np.empty((n_class, n), dtype=np.float64)
    cnt = np.empty(n_class, dtype=np.int64)
    for c in range(n_class):
        maskb = np.equal(y, c)
        M[c] = maskb
        cnt[c] = maskb.sum()
    for j in cont_cols:
        v = np.ascontiguousarray(values[:, j], dtype=np.float64)
        out[j] = np.stack([cnt.astype(np.float64), M @ v, M @ (v * v)])
    return out


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class _NBStreamState:
    """Cap sizing, per-chunk guards, and host-moment accumulation of the
    streamed trainer."""

    def __init__(self, enc: DatasetEncoder):
        ffields = enc.feature_fields
        self.enc = enc
        self.F = len(ffields)
        self.binned = [j for j, f in enumerate(ffields)
                       if f.is_categorical() or f.is_bucket_width_defined()]
        self.cont_cols = [j for j in range(self.F) if j not in self.binned]
        self.bucket_cols = [j for j, f in enumerate(ffields)
                            if f.is_bucket_width_defined()]
        self.declared = [f.num_bins() if (f.is_bucket_width_defined()
                                          and f.max is not None) else 0
                         for f in ffields]
        self.mom_acc: Dict[int, np.ndarray] = {}
        self.num_bins_seen = np.zeros(self.F, dtype=np.int64)
        self.n_chunks = 0
        self.bins_cap: Optional[int] = None
        self.n_class_cap: Optional[int] = None

    def size_caps(self, x0: np.ndarray) -> None:
        """Bin/class extents from the declared schema and the first chunk,
        with 4 bins of headroom; data that overflows a cap later makes the
        trainer fall back to the one-shot encode."""
        obs0 = [int(x0[:, j].max()) + 1 if len(x0) else 0
                for j in self.binned]
        cat_card = [len(self.enc.vocabs[f.ordinal])
                    for f in self.enc.feature_fields if f.is_categorical()]
        self.bins_cap = max([1] + [self.declared[j] for j in self.bucket_cols]
                            + obs0 + cat_card) + 4
        self.n_class_cap = max(len(self.enc.class_vocab), 1)

    def accept(self, x, values, y, n, narrow: bool = True):
        """Guard and accumulate one encoded chunk; returns the (x, y) fold
        arrays (narrowed to int8 when ``narrow`` and the extents allow),
        None for an empty chunk.  Raises ``ChunkedEncodeUnsupported`` on a
        negative bin or a cap overflow."""
        from ..core.binning import ChunkedEncodeUnsupported

        if n == 0:
            return None
        for j in self.bucket_cols:
            if int(x[:, j].min()) < 0:
                raise ChunkedEncodeUnsupported("negative bin")
        mx = [int(x[:, j].max()) + 1 for j in self.binned]
        for j, m in zip(self.binned, mx):
            self.num_bins_seen[j] = max(self.num_bins_seen[j], m)
        if (max(mx, default=0) > self.bins_cap
                or int(y.max(initial=-1)) >= self.n_class_cap):
            raise ChunkedEncodeUnsupported("cap overflow")
        xs, ys = x, y
        if narrow:
            # bin codes fit int8: a quarter of the bytes to copy and read
            if self.bins_cap <= 127 and self.F <= 127:
                xs = xs.astype(np.int8)
            if self.n_class_cap <= 127:
                ys = ys.astype(np.int8)
        mom = _host_moments(values, y, self.n_class_cap, self.cont_cols)
        for j, m in mom.items():
            acc = self.mom_acc.get(j)
            self.mom_acc[j] = m.copy() if acc is None else acc + m
        self.n_chunks += 1
        return xs, ys


class BayesianDistribution:
    """The Naive Bayes distribution trainer job."""

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.tabular = config.get_boolean("tabular.input", True)
        if not self.tabular:
            raise NotImplementedError(
                "text mode (tabular.input=false) is not ported yet")
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)

    def run(self, in_path: str, out_path: str) -> Counters:
        counters = Counters()
        delim_in = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        lines = self._train_streamed(in_path, delim_in, delim, counters)
        if lines is None:
            ds = self._encode_monolithic(in_path, delim_in)
            lines = self.train_lines(ds, delim, counters)
        write_output(out_path, lines)
        return counters

    def _encode_monolithic(self, in_path: str, delim_in: str) -> EncodedDataset:
        """The one-shot encode, for inputs the chunked path cannot take."""
        return DatasetEncoder(self.schema).encode_path(in_path, delim_in)

    def _train_streamed(self, in_path: str, delim_in: str, delim: str,
                        counters: Counters) -> Optional[List[str]]:
        """Chunked training through ``core.pipeline``: the encode, guards
        and host moments of chunk c+1 run on the prefetch worker while
        chunk c is copied and counted on the device.  Chunks are
        ``pipeline.chunk.rows`` rows (or derived from
        ``pipeline.device.budget.bytes``), else ``ingest.chunk.bytes``
        bytes.  Count and class extents are capped from the schema and the
        first chunk; data that overflows a cap, a negative bin or an input
        the chunked encoder cannot take returns None, and the caller
        re-runs the one-shot encode, so results always equal it.

        With the ingest cache enabled, a validated artifact for this input,
        encoder, delimiter and ``chunk_rows`` is replayed instead
        (``_train_warm``); on a miss this cold scan tees its encoded
        chunks into a new artifact."""
        from ..core import ingestcache, pipeline
        from ..core.binning import ChunkedEncodeUnsupported

        enc = DatasetEncoder(self.schema)
        F = len(enc.feature_fields)
        chunk_bytes = self.config.get_int("ingest.chunk.bytes", 48 << 20)
        # device-budget row estimate: an int32 x row + y
        chunk_rows = self.config.pipeline_chunk_rows(row_bytes=4 * (F + 1))
        depth = self.config.pipeline_prefetch_depth()
        st = _NBStreamState(enc)

        cache = ingestcache.IngestCache.from_config(self.config, in_path,
                                                    enc, delim_in)
        builder = None
        if cache is not None:
            scan = cache.load(chunk_rows)
            if scan is not None:
                return self._train_warm(scan, enc, st, counters, delim)
            builder = cache.builder(chunk_rows)
        try:
            gen = enc.encode_path_chunks(in_path, delim_in,
                                         chunk_bytes=chunk_bytes,
                                         chunk_rows=chunk_rows)
            first, gen = pipeline.peek(gen)
            if first is None:
                return None
            # declared categorical cardinalities are pre-seeded into the
            # vocab, so the emit loop walks len(vocab) bins even when the
            # data uses fewer: the count table must cover them
            st.size_caps(first[0])

            def chunks():
                for x, values, y, n in gen:
                    out = st.accept(x, values, y, n)
                    if out is None:
                        continue
                    if builder is not None:
                        builder.add(x, values, y, n)
                    yield out

            total = pipeline.streaming_fold(
                chunks(), _nb_local,
                static_args=(st.n_class_cap, st.bins_cap),
                device=self.device, prefetch_depth=depth)
        except ChunkedEncodeUnsupported:
            if builder is not None:
                builder.abort()
            return None
        if total is None:
            if builder is not None:
                builder.abort()
            return None
        if builder is not None:
            builder.finish()
        return self._streamed_model_lines(enc, st, total, counters, delim)

    def _train_warm(self, scan, enc: DatasetEncoder, st: _NBStreamState,
                    counters: Counters, delim: str) -> Optional[List[str]]:
        """The warm half of ``_train_streamed``: replay the cache
        artifact's recorded chunks off mmap, with no parse and no encode,
        through the same stream state (caps, guards, host moments), so
        every output byte equals the cold run's.  With the raw matrix
        present and ``ingest.cache.fused`` on, the fold ships the pre-bin
        integers and bins inside the count (``_nb_local_rawbin``);
        otherwise it folds the stored binned matrix with ``_nb_local``."""
        from ..core import ingestcache, pipeline
        from ..core.binning import ChunkedEncodeUnsupported

        scan.seed_encoder(enc)
        depth = self.config.pipeline_prefetch_depth()
        use_raw = (scan.xraw is not None and self.config.get_boolean(
            ingestcache.KEY_CACHE_FUSED, True))
        sl0 = scan.chunk_slice(0)
        if sl0 is None:
            return None
        st.size_caps(np.asarray(sl0[0]))

        def chunks():
            for item in scan.chunks(with_raw=use_raw):
                if use_raw:
                    xraw, x, values, y, n, _ = item
                else:
                    x, values, y, n, _ = item
                out = st.accept(x, values, y, n)
                if out is None:
                    continue
                xs, ys = out
                yield (xraw, ys) if use_raw else (xs, ys)

        try:
            if use_raw:
                total = pipeline.streaming_fold(
                    chunks(), _nb_local_rawbin,
                    static_args=(st.n_class_cap, st.bins_cap,
                                 rawbin_widths(enc)),
                    device=self.device, prefetch_depth=depth)
            else:
                total = pipeline.streaming_fold(
                    chunks(), _nb_local,
                    static_args=(st.n_class_cap, st.bins_cap),
                    device=self.device, prefetch_depth=depth)
        except ChunkedEncodeUnsupported:
            return None
        if total is None:
            return None
        return self._streamed_model_lines(enc, st, total, counters, delim)

    def _streamed_model_lines(self, enc: DatasetEncoder,
                              st: _NBStreamState, total, counters: Counters,
                              delim: str) -> List[str]:
        """Model lines from a streamed count fold."""
        counters.set("Ingest", "Chunks", st.n_chunks)
        ffields = enc.feature_fields
        F = len(ffields)
        n_class = len(enc.class_vocab)
        counts = np.asarray(total)[:n_class]
        moments = {j: m[:, :n_class] for j, m in st.mom_acc.items()}

        num_bins = []
        for j, f in enumerate(ffields):
            if f.is_categorical():
                num_bins.append(len(enc.vocabs[f.ordinal]))
            elif f.is_bucket_width_defined():
                num_bins.append(max(st.declared[j], int(st.num_bins_seen[j])))
            else:
                num_bins.append(0)
        ds_meta = EncodedDataset(
            schema=enc.schema, feature_fields=ffields,
            x=np.zeros((0, F), np.int32), values=np.zeros((0, F)),
            y=np.zeros(0, np.int32), num_bins=num_bins,
            bin_offset=np.zeros(F, np.int32),
            binned_mask=np.array([f.is_categorical()
                                  or f.is_bucket_width_defined()
                                  for f in ffields], dtype=bool),
            vocabs=enc.vocabs, class_vocab=enc.class_vocab)
        return self._emit_model_lines(ds_meta, counts, moments, delim,
                                      counters)

    def train_lines(self, ds: EncodedDataset, delim: str,
                    counters: Counters) -> List[str]:
        """The one-shot pass: count the whole encoded dataset on the
        device and emit reference-format lines."""
        n_class = len(ds.class_vocab)
        F = ds.n_features
        max_bins = max([b for b in ds.num_bins] + [1])
        cont_cols = [j for j in range(F) if not ds.binned_mask[j]]
        xs, ys = ds.x, ds.y
        if max_bins <= 127 and F <= 127:
            xs = xs.astype(np.int8)
        if n_class <= 127:
            ys = ys.astype(np.int8)
        counts = sharded_reduce(_nb_local, xs, ys, device=self.device,
                                static_args=(n_class, max_bins)).cpu().numpy()
        moments = _host_moments(ds.values, ds.y, n_class, cont_cols)
        return self._emit_model_lines(ds, counts, moments, delim, counters)

    def _emit_model_lines(self, ds: EncodedDataset, counts, moments,
                          delim: str, counters: Counters) -> List[str]:
        n_class = len(ds.class_vocab)
        F = ds.n_features
        lines: List[str] = []
        # feature-prior continuous accumulators: ord -> [count, sum, sumsq]
        prior_mom: Dict[int, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])

        # grouped by (class, ordinal, bin) in encoding order; loaders
        # dispatch on the empty-column tags, not on line order
        for c in range(n_class):
            class_val = ds.class_vocab.values[c]
            for j in range(F):
                f = ds.feature_fields[j]
                ordinal = f.ordinal
                if ds.binned_mask[j]:
                    for b in range(ds.num_bins[j]):
                        cnt = int(counts[c, j, b])
                        if cnt == 0:
                            continue  # the reference only sees observed keys
                        bin_label = ds.bin_label(j, b)
                        counters.incr("Distribution Data", "Feature posterior binned ")
                        lines.append(f"{class_val}{delim}{ordinal}{delim}{bin_label}{delim}{cnt}")
                        counters.incr("Distribution Data", "Class prior")
                        lines.append(f"{class_val}{delim}{delim}{delim}{cnt}")
                        counters.incr("Distribution Data", "Feature prior binned ")
                        lines.append(f"{delim}{ordinal}{delim}{bin_label}{delim}{cnt}")
                else:
                    mom = moments[j]
                    cnt = int(mom[0, c])
                    if cnt == 0:
                        continue
                    vsum = int(mom[1, c])
                    vsq = int(mom[2, c])
                    mean = _jdiv(vsum, cnt)
                    std = _jstd(vsq, cnt, mean)
                    counters.incr("Distribution Data", "Feature posterior cont ")
                    lines.append(f"{class_val}{delim}{ordinal}{delim}{delim}{mean}{delim}{std}")
                    counters.incr("Distribution Data", "Class prior")
                    lines.append(f"{class_val}{delim}{delim}{delim}{cnt}")
                    pm = prior_mom[ordinal]
                    pm[0] += cnt
                    pm[1] += vsum
                    pm[2] += vsq

        # Gaussian feature priors across classes
        for ordinal, (cnt, vsum, vsq) in sorted(prior_mom.items()):
            counters.incr("Distribution Data", "Feature prior cont ")
            mean = _jdiv(int(vsum), int(cnt))
            std = _jstd(int(vsq), int(cnt), mean)
            lines.append(f"{delim}{ordinal}{delim}{delim}{mean}{delim}{std}")
        return lines


# ---------------------------------------------------------------------------
# model (the reference's text format)
# ---------------------------------------------------------------------------

class _FeatureDistr:
    """Per-(scope, ordinal) distribution: bin counts or Gaussian params."""

    __slots__ = ("bins", "mean", "std", "total")

    def __init__(self):
        self.bins: Dict[str, int] = defaultdict(int)
        self.mean: Optional[int] = None
        self.std: Optional[int] = None
        self.total = 0

    def prob(self, bin_or_val) -> float:
        if self.mean is not None:
            x = float(bin_or_val)
            sd = max(float(self.std), 1e-9)
            z = (x - self.mean) / sd
            return math.exp(-0.5 * z * z) / (sd * math.sqrt(2.0 * math.pi))
        if self.total <= 0:
            return 0.0
        return self.bins.get(str(bin_or_val), 0) / self.total


class NaiveBayesModel:
    """In-memory model; parses the reference text format (dispatch on the
    empty-column tags)."""

    def __init__(self):
        self.post: Dict[Tuple[str, int], _FeatureDistr] = defaultdict(_FeatureDistr)
        self.prior: Dict[int, _FeatureDistr] = defaultdict(_FeatureDistr)
        self.class_count: Dict[str, int] = defaultdict(int)
        self.class_prob: Dict[str, float] = {}
        self.total = 0

    @classmethod
    def load(cls, path: str, delim_regex: str = ",") -> "NaiveBayesModel":
        return cls.from_lines(read_lines(path), delim_regex)

    @classmethod
    def from_lines(cls, lines, delim_regex: str = ",") -> "NaiveBayesModel":
        m = cls()
        for line in lines:
            items = split_line(line, delim_regex)
            ordinal = int(items[1]) if items[1] != "" else -1
            if items[0] == "":
                if items[2] != "":
                    m.prior[ordinal].bins[items[2]] += int(items[3])
                else:
                    m.prior[ordinal].mean = int(items[3])
                    m.prior[ordinal].std = int(items[4])
            elif items[1] == "" and items[2] == "":
                m.class_count[items[0]] += int(items[3])
            else:
                if items[2] != "":
                    m.post[(items[0], ordinal)].bins[items[2]] += int(items[3])
                else:
                    m.post[(items[0], ordinal)].mean = int(items[3])
                    m.post[(items[0], ordinal)].std = int(items[4])
        m.finish_up()
        return m

    def finish_up(self) -> None:
        """Class probabilities normalized by the summed class counts;
        per-feature tables by their scope's count."""
        self.total = sum(self.class_count.values())
        for cv, cnt in self.class_count.items():
            self.class_prob[cv] = cnt / self.total if self.total else 0.0
        for (cv, _), d in self.post.items():
            d.total = self.class_count[cv]
        for d in self.prior.values():
            d.total = self.total

    def class_prior_prob(self, class_val: str) -> float:
        return self.class_prob.get(class_val, 0.0)


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

class BayesianPredictor:
    """Map-only scoring job, vectorized over the batch on the device."""

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None,
                 model: Optional[NaiveBayesModel] = None, device=None):
        self.config = config
        self.tabular = config.get_boolean("tabular.input", True)
        if not self.tabular:
            raise NotImplementedError(
                "text mode (tabular.input=false) is not ported yet")
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.model = model or NaiveBayesModel.load(
            config.must("bayesian.model.file.path"),
            config.field_delim_regex())
        self.device = resolve_device(device)
        # float32 (log space) is the default; float64 reproduces the
        # reference's raw double products byte for byte
        self.score_precision = config.get("bp.score.precision", "float32")
        if self.score_precision not in ("float64", "float32"):
            raise ValueError(
                f"invalid bp.score.precision: {self.score_precision}")

        delim = self.config.field_delim_out()
        pc = self.config.get("bp.predict.class")
        if pc is not None:
            self.predicting_classes = pc.split(delim)
        else:
            card = self.schema.class_attr_field().cardinality
            self.predicting_classes = [card[0], card[1]]

        costs = self.config.get("bp.predict.class.cost")
        self.arbitrator = None
        if costs is not None:
            c = costs.split(delim)
            self.arbitrator = CostBasedArbitrator(
                self.predicting_classes[0], self.predicting_classes[1],
                int(c[0]), int(c[1]))
        self.class_prob_diff_threshold = self.config.get_int(
            "class.prob.diff.threshold", -1)
        self.output_feature_prob_only = self.config.get_boolean(
            "output.feature.prob.only", False)

    def _build_tables(self, ds: EncodedDataset):
        """Per-class probability lookup tables aligned to the predict-time
        encoding, built on the host."""
        F = ds.n_features
        max_bins = max([b for b in ds.num_bins] + [1])
        C = len(self.predicting_classes)
        post = np.zeros((C, F, max_bins))
        prior = np.zeros((F, max_bins))
        gauss_post = np.zeros((C, F, 2))   # mean, std
        gauss_prior = np.zeros((F, 2))
        is_cont = ~ds.binned_mask
        for j, f in enumerate(ds.feature_fields):
            if ds.binned_mask[j]:
                for b in range(ds.num_bins[j]):
                    label = ds.bin_label(j, b)
                    prior[j, b] = self.model.prior[f.ordinal].prob(label)
                    for ci, cv in enumerate(self.predicting_classes):
                        post[ci, j, b] = self.model.post[(cv, f.ordinal)].prob(label)
            else:
                d = self.model.prior[f.ordinal]
                gauss_prior[j] = (d.mean or 0, d.std or 0)
                for ci, cv in enumerate(self.predicting_classes):
                    dp = self.model.post[(cv, f.ordinal)]
                    gauss_post[ci, j] = (dp.mean or 0, dp.std or 0)
        class_prior = np.asarray(
            [self.model.class_prior_prob(cv) for cv in self.predicting_classes])
        return post, prior, gauss_post, gauss_prior, class_prior, is_cont

    @staticmethod
    def _score_batch(x, values, post, prior, gauss_post, gauss_prior,
                     class_prior, is_cont):
        """``classPostProb[n, C] = int(featPost * classPrior / featPrior *
        100)`` in float64 with the reference's raw products; returns
        ``(probs int32 [n, C], feat_prior [n], feat_post [n, C])``."""
        n, F = x.shape
        C = post.shape[0]
        xc = x.long().clamp(0, post.shape[2] - 1)
        cols = torch.arange(F, device=x.device)

        def gauss(v, params):
            mean = params[..., 0]
            std = params[..., 1].clamp_min(1e-9)
            z = (v - mean) / std
            return exp_f64(-0.5 * z * z) / (std * _SQRT_2PI)

        prior_f = torch.where(is_cont[None, :],
                              gauss(values, gauss_prior[None, :, :]),
                              prior[cols[None, :], xc])
        feat_prior = _prod_last(prior_f)                                # [n]
        post_pick = post[torch.arange(C, device=x.device)[None, :, None],
                         cols[None, None, :], xc[:, None, :]]          # [n, C, F]
        post_f = torch.where(is_cont[None, None, :],
                             gauss(values[:, None, :], gauss_post[None]),
                             post_pick)
        feat_post = _prod_last(post_f)                                  # [n, C]
        ratio = (feat_post * class_prior[None, :]
                 / feat_prior[:, None].clamp_min(1e-300))
        return _java_int32(ratio * 100), feat_prior, feat_post

    @staticmethod
    def _score_batch_f32(x, values, post, prior, gauss_post, gauss_prior,
                         class_prior, is_cont):
        """Log-space float32 scoring, the default path.  Tail density
        products underflow float32, so this path sums float32 logs and
        exponentiates once; it agrees with the float64 path within the
        contract that ``f32_score_parity_violations`` checks, and returns
        the mathematically right ratio on rows whose float64 products
        underflow.  A bin unseen in training (zero posterior) yields
        probability 0, as the float64 path does.  The bin pick is a gather,
        so it is exact."""
        f32 = torch.float32
        dev = x.device
        x = x.long()
        values = values.to(f32)
        post = post.to(f32)
        prior = prior.to(f32)
        gauss_post = gauss_post.to(f32)
        gauss_prior = gauss_prior.to(f32)
        class_prior = class_prior.to(f32)
        n, F = x.shape
        C = post.shape[0]
        xc = x.clamp(0, post.shape[2] - 1)
        cols = torch.arange(F, device=dev)
        half_log_2pi = torch.tensor(0.5 * math.log(2.0 * math.pi), dtype=f32)

        def log_gauss(v, params):
            mean = params[..., 0]
            std = params[..., 1].clamp_min(1e-9)
            z = (v - mean) / std
            # -0.5*z*z - log(std) with the multiply and the subtract in
            # one rounding, as XLA's backend contracts them
            return fma_f32(z, z * -0.5, -log_f32(std)) - half_log_2pi

        tiny = 1e-30
        prior_pick = prior[cols[None, :], xc]                           # [n, F]
        post_pick = post[torch.arange(C, device=dev)[None, :, None],
                         cols[None, None, :], xc[:, None, :]]          # [n, C, F]
        lprior_f = torch.where(
            is_cont[None, :], log_gauss(values, gauss_prior[None, :, :]),
            log_f32(prior_pick.clamp_min(tiny)))
        lfeat_prior = _sum_last(lprior_f)                               # [n]
        lpost_f = torch.where(
            is_cont[None, None, :],
            log_gauss(values[:, None, :], gauss_post[None]),
            log_f32(post_pick.clamp_min(tiny)))
        lfeat_post = _sum_last(lpost_f)                                 # [n, C]
        lratio = (lfeat_post + log_f32(class_prior)[None, :]
                  - lfeat_prior[:, None])
        probs = _java_int32(torch.exp(lratio) * 100)
        # a true zero posterior factor must give probability 0, as the
        # float64 product does; the tiny clamp would otherwise cancel
        # against a matching zero prior factor in log space
        post_zero = ((~is_cont)[None, None, :] & (post_pick <= 0)).any(dim=2)
        prior_zero = ((~is_cont)[None, :] & (prior_pick <= 0)).any(dim=1)
        probs = torch.where(post_zero, torch.zeros_like(probs), probs)
        # the feature probabilities exponentiate in float64 (tail products
        # below ~1e-38 would flush to 0 in float32), with XLA's exp: they
        # are printed as they are in prob-only mode
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        return (probs,
                torch.where(prior_zero, zero, exp_f64(lfeat_prior.double())),
                torch.where(post_zero, zero, exp_f64(lfeat_post.double())))

    @staticmethod
    def log_oracle(x, values, post, prior, gauss_post, gauss_prior,
                   is_cont):
        """Host float64 log-space ``(lfeat_prior[n], lfeat_post[n, C])``,
        which cannot underflow: the parity checker's ground truth."""
        x = np.asarray(x)
        values = np.asarray(values, np.float64)
        xc = np.clip(x, 0, post.shape[2] - 1)
        cols = np.arange(x.shape[1])
        zp = (values - gauss_prior[None, :, 0]) / np.maximum(
            gauss_prior[None, :, 1], 1e-9)
        lg_prior = (-0.5 * zp * zp - np.log(np.maximum(
            gauss_prior[None, :, 1], 1e-9)) - 0.5 * np.log(2 * np.pi))
        with np.errstate(divide="ignore"):
            lprior_f = np.where(is_cont[None, :], lg_prior,
                                np.log(prior[cols[None, :], xc]))
            zo = ((values[:, None, :] - gauss_post[None, :, :, 0])
                  / np.maximum(gauss_post[None, :, :, 1], 1e-9))
            lg_post = (-0.5 * zo * zo - np.log(np.maximum(
                gauss_post[None, :, :, 1], 1e-9))
                - 0.5 * np.log(2 * np.pi))
            lpost_f = np.where(
                is_cont[None, None, :], lg_post,
                np.log(post[np.arange(post.shape[0])[None, :, None],
                            cols[None, None, :], xc[:, None, :]]))
        return lprior_f.sum(axis=1), lpost_f.sum(axis=2)

    @staticmethod
    def f32_score_parity_violations(p64, p32, lfeat_prior, lfeat_post,
                                    class_prior, ln_healthy):
        """Count violations of the float32-vs-float64 contract.  On healthy
        rows (every log-product above ``ln_healthy``, the floor of the
        float64 path's usable range: ~ln(1e-250) for IEEE doubles) the int
        probabilities agree within max(2, 0.1%), or 0.3% near int32
        saturation; on tail rows the float32 result matches the log-space
        oracle, and a true-zero posterior gives exactly 0.  Returns a dict
        of counts; all zero means the contract holds."""
        p64 = np.asarray(p64, np.float64)
        p32 = np.asarray(p32, np.float64)
        maxi = float(np.iinfo(np.int32).max)
        sat_band = (1 - 3e-3) * maxi
        healthy = ((lfeat_prior > ln_healthy)[:, None]
                   & (lfeat_post > ln_healthy))
        d = np.abs(p32 - p64)
        tol = np.maximum(2.0, np.abs(p64) * 1e-3)
        tol = np.maximum(tol, (np.abs(p64) > 1e8) * 3e-3 * np.abs(p64))
        ok_h = (d <= tol) | ((p64 >= sat_band) & (p32 >= sat_band))
        with np.errstate(over="ignore", invalid="ignore"):
            oracle = np.exp(lfeat_post + np.log(class_prior)[None, :]
                            - lfeat_prior[:, None]) * 100.0
        o_clamp = np.minimum(oracle, maxi)
        ok_finite = ((np.abs(p32 - o_clamp)
                      <= np.maximum(1.0, 1e-3 * o_clamp))
                     | ((p32 >= sat_band) & (oracle >= sat_band)))
        finite = (np.isfinite(lfeat_post)
                  & np.isfinite(lfeat_prior)[:, None])
        post_zero = np.isneginf(lfeat_post)
        ok_t = np.where(post_zero, p32 == 0,
                        np.where(finite, ok_finite, True))
        return {"healthy": int((healthy & ~ok_h).sum()),
                "tail": int((~healthy & ~ok_t).sum()),
                "n_healthy": int(healthy.sum()),
                "n_tail": int((~healthy).sum())}

    def score(self, records):
        """Encode ``records`` and score them on the device with the
        configured precision; returns ``(ds, tables, probs, feat_prior,
        feat_post)`` with host numpy results."""
        ds = DatasetEncoder(self.schema).encode(records)
        tables = self._build_tables(ds)
        score_fn = (self._score_batch_f32
                    if self.score_precision == "float32"
                    else self._score_batch)
        dev = self.device
        probs, feat_prior, feat_post = score_fn(
            torch.from_numpy(ds.x).to(dev), torch.from_numpy(ds.values).to(dev),
            *predictor_tables_to_device(tables, dev))
        return (ds, tables, probs.cpu().numpy(), feat_prior.cpu().numpy(),
                feat_post.cpu().numpy())

    def run(self, in_path: str, out_path: str) -> Counters:
        """Score ``in_path`` and write one prediction line per record."""
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        raw_lines = list(read_lines(in_path))
        records = [split_line(l, delim_regex) for l in raw_lines]
        _, _, probs, feat_prior, feat_post = self.score(records)
        cls_ord = self.schema.class_attr_field().ordinal
        actuals = [r[cls_ord] for r in records]
        out = self.emit_lines(raw_lines, records, actuals, probs, feat_prior,
                              feat_post, delim, counters)
        write_output(out_path, out)
        return counters

    def emit_lines(self, raw_lines, records, actuals, probs, feat_prior,
                   feat_post, delim, counters,
                   with_confusion: bool = True) -> List[str]:
        """Arbitration and output-line formatting.  ``with_confusion=False``
        skips the confusion-matrix percentage counters (their integer
        divisions need both classes present)."""
        conf = ConfusionMatrix(self.predicting_classes[0], self.predicting_classes[1])
        out: List[str] = []
        # one stable argsort for the batch picks, per row, the same class
        # as the reference's per-row stable argsort
        order_all = np.argsort(-np.asarray(probs), axis=1, kind="stable")
        for i, line in enumerate(raw_lines):
            actual = actuals[i]
            if self.output_feature_prob_only:
                parts = [records[i][0], str(feat_prior[i])]
                for ci, cv in enumerate(self.predicting_classes):
                    parts += [cv, str(feat_post[i, ci])]
                parts.append(actual)
                out.append(delim.join(parts))
                continue

            row = probs[i]
            if self.arbitrator is not None:
                pos = int(row[1]); neg = int(row[0])
                pred = self.arbitrator.arbitrate(pos, neg)
                prob = 100
                suffix = ""
            else:
                order = order_all[i]
                pred = self.predicting_classes[int(order[0])]
                prob = int(row[order[0]])
                suffix = ""
                if self.class_prob_diff_threshold > 0:
                    diff = int(row[order[0]] - row[order[1]]) if len(row) > 1 else 100
                    suffix = delim + ("classified" if diff > self.class_prob_diff_threshold
                                      else "ambiguous")
            conf.report(pred, actual)
            if pred == actual:
                counters.incr("Validation", "Correct")
            else:
                counters.incr("Validation", "Incorrect")
            out.append(f"{line}{delim}{pred}{delim}{prob}{suffix}")

        if not self.output_feature_prob_only:
            conf.to_counters(counters)
        return out
