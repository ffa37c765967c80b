"""Naive Bayes: distribution trainer + batch predictor on a CUDA card or
over the positions of a device mesh.

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

Text mode (``tabular.input=false``): the trainer tokenizes ``text,class``
rows with the reference's analyzer (``models.text``) and counts (token,
class) pairs with K1 at F = 1 over the token vocabulary; the predictor
scores each row's tokens on the host in float64, as the reference does.

Training parses with the native C ingest (core.binning, ``native/``),
``ingest.parse.threads`` chunks at a time, and carries the reference's
resilience layer: the sidecar checkpoint every
``checkpoint.interval.chunks`` chunks and ``--resume`` from it
(core.checkpoint), row quarantine under ``ingest.error.budget`` with
per-row salvage of a rejected chunk (core.resilience), the retried read
and the fault points (core.faultinject), and the reference's spans
(``job:BayesianDistribution``, ``phase:train``/``load``/``emit``,
``ingest.*``, ``checkpoint.save``; core.obs).  With
``telemetry.drift.baseline.path`` naming an earlier model, training also
sets the reference's ``drift.<feature>`` gauges and ``Drift`` counters
(core.telemetry).

With ``ingest.cache.enable`` the first streamed training scan also
writes the parse-once ingest cache (core.ingestcache), and later runs
replay its mmapped matrices instead of parsing; the warm fold bins inside
the count with kernel K2 (``ops.counting.feature_class_counts_rawbin``).

Every job takes ``mesh=`` as the reference's does: training (monolithic,
streamed cold and warm, text mode) pads and shards each chunk's rows over
every mesh position and sums the positions' tables with the mesh's
``psum`` (``core.pipeline.streaming_fold(mesh=)``,
``ops.counting.sharded_reduce(mesh=)``), and scoring shards the rows over
the mesh's ``data`` axis and scores each shard on its own device.  Counts
are integers and scoring is row-local, so every output byte equals the
one-device run's.

Float32 matrix products never run here: the bin pick is a gather, which
is exact, so TF32 cannot round it.  The float64 factors use XLA's float64
``exp`` and the float32 log-space sums XLA's float32 ``log``, its
contracted multiply-adds (ops.xla_math) and its order of summation
(``_sum_last``), so the feature probabilities that
``output.feature.prob.only`` prints are the reference's bits.

``BayesianDistribution.fold_spec`` exports the trainer's part of a shared
scan (core.multiscan): ``_NBFoldSpec`` shares the schema encode, and the
copy, with every co-registered job on the same schema file, and writes the
model a standalone streamed run writes (None in text mode).
"""

from __future__ import annotations

import math
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import telemetry
from ..core.binning import DatasetEncoder, EncodedDataset
from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import ConfusionMatrix, CostBasedArbitrator, Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..core.obs import get_tracer, traced_run
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


def _sum_seq(t: torch.Tensor, s: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """``s`` plus the columns of ``t``, left to right."""
    for k in range(t.shape[-1]):
        s = t[..., k] if s is None else s + t[..., k]
    return s


def _sum_tree(v: torch.Tensor) -> torch.Tensor:
    """A horizontal vector sum as x86 lowers LLVM's reassociating
    ``vector.reduce.fadd``: lane i + lane i + w/2, halving w to 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _sum_lanes(t: torch.Tensor, vf: int, steps: int) -> torch.Tensor:
    """``steps`` vector iterations of width ``vf`` over the first
    ``vf * steps`` columns (lane i takes columns i, i + vf, ...), then the
    horizontal sum."""
    acc = t[..., :vf]
    for j in range(1, steps):
        acc = acc + t[..., j * vf:(j + 1) * vf]
    return _sum_tree(acc)


def _sum_window(t: torch.Tensor) -> torch.Tensor:
    """XLA CPU's fused float32 row sum of at most 32 columns: LLVM's loop
    vectorizer on the fully unrolled column loop (AVX-512 host, 256-bit
    preferred vectors), read from the optimized IR of
    ``jax.jit(BayesianPredictor._score_batch_f32)`` at every width."""
    F = t.shape[-1]
    if F < 16:                          # not vectorized along the row
        return _sum_seq(t)
    if F < 20:
        # one 16-wide step, then the rest left to right (the 2-wide
        # epilogue step at 18 and 19 columns adds in that same order)
        return _sum_seq(t[..., 16:], _sum_lanes(t, 16, 1))
    if F < 24:
        # four interleaved 4-wide parts over columns 0-15, folded
        # ((p0 + p1) + p2) + p3; a 4-wide epilogue step whose lane 0
        # starts from that sum; the rest left to right
        s = _sum_lanes(t, 4, 4)
        s = _sum_tree(torch.cat([(s + t[..., 16])[..., None],
                                 t[..., 17:20]], dim=-1))
        return _sum_seq(t[..., 20:], s)
    if F < 32:                          # three 8-wide steps, then the rest
        return _sum_seq(t[..., 24:], _sum_lanes(t, 8, 3))
    return _sum_lanes(t, 16, 2)


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis in the order of XLA CPU's fused
    reduction, so the float32 scorer's log-sums are the reference's bits
    on the card and on the CPU alike.  Up to 32 columns: ``_sum_window``.
    Wider: XLA's tree-reduction rewrite, read from the optimized HLO: the
    row is padded to a multiple of 32 (half the padding, rounded down, on
    the left), each 32-wide window is summed left to right, and the window
    sums are reduced as a row of their own.  Bit-checked against
    ``jax.jit`` at every width from 1 to 64 and at several up to 1,030.
    The vector widths are LLVM's choice for the host CPU that ran XLA;
    another host may vectorize otherwise (ROADMAP, queue 3)."""
    F = t.shape[-1]
    if F <= 32:
        return _sum_window(t)
    width = -(-F // 32) * 32
    lo = (width - F) // 2
    bounds = list(range(32 - lo, F, 32))
    wins = [_sum_seq(t[..., a:b])
            for a, b in zip([0] + bounds, bounds + [F])]
    return _sum_last(torch.stack(wins, dim=-1))


def _nb_local(x, y, mask, n_class, max_bins, out=None):
    """The fold's ``local_fn``: one chunk's count table, added into
    ``out`` when given."""
    return feature_class_counts(x, y, n_class, max_bins, mask=mask, out=out)


def _nb_local_rawbin(x, y, mask, n_class, max_bins, widths, out=None):
    """The warm ingest-cache fold: ``x`` holds the cache's pre-bin raw
    integers, binned inside the count (kernel K2 on the card)."""
    return feature_class_counts_rawbin(x, y, n_class, max_bins, widths,
                                       mask=mask, out=out)


def _aborting_salvage(builder, inner):
    """A salvage callable that first aborts the ingest-cache build: the
    artifact must equal a clean encode of the input bytes, and a
    salvaged (quarantined) chunk means this scan's output does not."""
    def salvage(chunk):
        builder.abort()
        return inner(chunk)
    return salvage


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


def load_model_feature_counts(path: str, delim: str = ","
                              ) -> Dict[int, Dict[str, int]]:
    """Per-feature bin counts out of a written NB model file,
    ``{ordinal: {bin_label: count}}``, summed over the feature-prior
    binned lines (``<empty><delim>ord<delim>bin<delim>n``): the stored
    baseline side of the drift gauges, in the shape
    ``core.telemetry.count_drift`` takes."""
    out: Dict[int, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for line in read_lines(path):
        parts = line.split(delim)
        # feature prior binned: ["", ordinal, bin_label, count]; class
        # priors have parts[1] == "", posteriors have parts[0] != "",
        # continuous priors have 5 parts
        if (len(parts) == 4 and parts[0] == ""
                and parts[1] != "" and parts[2] != ""):
            try:
                out[int(parts[1])][parts[2]] += int(parts[3])
            except ValueError:
                continue
    return {k: dict(v) for k, v in out.items()}


class BayesianDistribution:
    """The Naive Bayes distribution trainer job."""

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.tabular = config.get_boolean("tabular.input", True)
        if self.tabular:
            self.schema = schema or FeatureSchema.from_file(
                config.must("feature.schema.file.path"))
        else:
            self.schema = schema      # text mode needs no feature schema
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        """Train on ``in_path`` and write the model: on this job's device,
        or with ``mesh`` over its positions (a mesh of one position is
        its device)."""
        counters = Counters()
        delim_in = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        if not self.tabular:
            return self._run_text(in_path, out_path, counters, delim_in,
                                  delim, mesh)
        tracer = get_tracer()
        with tracer.span("phase:train"):
            lines = self._train_streamed(in_path, delim_in, delim, counters,
                                         mesh, out_path=out_path)
            if lines is None:
                with tracer.span("phase:load"):
                    ds = self._encode_monolithic(in_path, out_path, delim_in,
                                                 counters)
                lines = self.train_lines(ds, delim, counters, mesh=mesh)
        with tracer.span("phase:emit"):
            write_output(out_path, lines)
        return counters

    def _encode_monolithic(self, in_path: str, out_path: str,
                           delim_in: str, counters: Counters
                           ) -> EncodedDataset:
        """The one-shot encode, for inputs the chunked path cannot take.
        With an ``ingest.error.budget`` it first moves malformed rows to
        the quarantine sidecar, as the chunked path does per chunk."""
        from ..core.resilience import RowQuarantine, row_guard

        enc = DatasetEncoder(self.schema)
        quarantine = RowQuarantine.from_config(
            self.config, out_path + ".quarantine")
        if quarantine is None:
            return enc.encode_path(in_path, delim_in)
        guard = row_guard(enc)
        good, bad = [], []
        for line in read_lines(in_path):
            fields = split_line(line, delim_in)
            if guard(fields):
                good.append(fields)
            else:
                bad.append(line)
        if bad:
            quarantine.record(bad, "rows rejected by schema guard")
        quarantine.admit(len(good))
        quarantine.finish(counters)
        return enc.encode(good)

    def _train_streamed(self, in_path: str, delim_in: str, delim: str,
                        counters: Counters, mesh=None,
                        out_path: Optional[str] = None
                        ) -> Optional[List[str]]:
        """Chunked training through ``core.pipeline``: the C encode,
        guards and host moments of chunk c+1 run on the prefetch worker
        while chunk c is copied and counted on the device.  Chunks are
        ``pipeline.chunk.rows`` rows (or derived from
        ``pipeline.device.budget.bytes``), else ``ingest.chunk.bytes``
        bytes, and ``ingest.parse.threads`` > 1 parses them in parallel.
        Count and class extents are capped from the schema and the first
        chunk; data that overflows a cap, a negative bin or an input the
        chunked encoder cannot take returns None, and the caller re-runs
        the one-shot encode, so results always equal it.  With a ``mesh``
        of several positions each chunk's rows shard over its positions
        (``streaming_fold(mesh=)``).

        With the ingest cache enabled, a validated artifact for this input,
        encoder, delimiter and ``chunk_rows`` is replayed instead
        (``_train_warm``); on a miss this cold scan tees its encoded
        chunks into a new artifact.

        With ``checkpoint.interval.chunks`` set, a sidecar (carry,
        encoder, stream state, quarantine counts, byte offset) is written
        every N folded chunks, and ``--resume`` restarts mid-file with
        byte-identical output; with ``ingest.error.budget`` set,
        malformed rows go to a quarantine sidecar instead of failing the
        chunk."""
        from ..core import ingestcache, pipeline
        from ..core.binning import ChunkedEncodeUnsupported
        from ..core.checkpoint import StreamCheckpointer
        from ..core.parparse import parse_threads_from_config
        from ..core.resilience import RowQuarantine, salvage_chunk

        enc = DatasetEncoder(self.schema)
        F = len(enc.feature_fields)
        chunk_bytes = self.config.get_int("ingest.chunk.bytes", 48 << 20)
        # device-budget row estimate: an int32 x row + y
        chunk_rows = self.config.pipeline_chunk_rows(row_bytes=4 * (F + 1))
        depth = self.config.pipeline_prefetch_depth()
        sidecar_base = out_path if out_path is not None else in_path
        ck = StreamCheckpointer.from_config(
            self.config, kind="nb-train", in_path=in_path,
            default_path=sidecar_base + ".ckpt",
            params={"chunk_bytes": chunk_bytes, "chunk_rows": chunk_rows,
                    "delim": delim_in})
        quarantine = RowQuarantine.from_config(
            self.config, sidecar_base + ".quarantine")

        st = _NBStreamState(enc)
        start_offset = 0
        initial_carry = None
        resumed = False
        if ck is not None and ck.resume:
            payload = ck.load()
            if payload is not None:
                # the checkpointed encoder and stream state replace the
                # fresh ones: vocabularies, caps, moments and budget
                # counts continue where the checkpoint left them
                enc = payload["state"]["enc"]
                st = payload["state"]["st"]
                if quarantine is not None and payload["state"].get("q"):
                    quarantine.restore(payload["state"]["q"])
                initial_carry = payload["carry"]
                start_offset = payload["offset"]
                resumed = True

        # a resumed run keeps the cold path: its offset is into the raw
        # file, not the cache
        cache = ingestcache.IngestCache.from_config(self.config, in_path,
                                                    enc, delim_in)
        builder = None
        if cache is not None and not resumed:
            scan = cache.load(chunk_rows)
            if scan is not None:
                lines = self._train_warm(scan, enc, st, counters, delim,
                                         quarantine, mesh)
                if lines is not None and ck is not None:
                    ck.complete()
                return lines
            builder = cache.builder(chunk_rows)

        salvage = (salvage_chunk(enc, quarantine, delim_in)
                   if quarantine is not None else None)
        if builder is not None and salvage is not None:
            salvage = _aborting_salvage(builder, salvage)
        try:
            gen = enc.encode_path_chunks(
                in_path, delim_in, chunk_bytes=chunk_bytes,
                chunk_rows=chunk_rows, start_offset=start_offset,
                with_offsets=True, salvage=salvage,
                parse_threads=parse_threads_from_config(self.config))
            if not resumed:
                first, gen = pipeline.peek(gen)
                if first is None:
                    return None
                # declared categorical cardinalities are pre-seeded into
                # the vocab, so the emit loop walks len(vocab) bins even
                # when the data uses fewer: the count table must cover them
                st.size_caps(first[0])

            def chunks():
                # a checkpoint token pickles the host state here, when
                # the chunk is produced: a prefetch worker running ahead
                # cannot leak a later chunk's state into it
                for x, values, y, n, idx, end in gen:
                    if quarantine is not None:
                        quarantine.admit(n)
                    out = st.accept(x, values, y, n)
                    if out is None:
                        continue
                    if builder is not None:
                        builder.add(x, values, y, n)
                    if ck is not None and ck.due(idx):
                        token = ck.token(idx, end, {
                            "enc": enc, "st": st,
                            "q": (quarantine.state()
                                  if quarantine is not None else None)})
                        yield pipeline.Checkpointed(out, token)
                    else:
                        yield out

            total = pipeline.streaming_fold(
                chunks(), _nb_local,
                static_args=(st.n_class_cap, st.bins_cap),
                device=self.device, mesh=mesh, prefetch_depth=depth,
                checkpointer=ck, initial_carry=initial_carry)
        except ChunkedEncodeUnsupported:
            if builder is not None:
                builder.abort()
            if ck is not None:
                # the fallback run supersedes any sidecar this attempt
                # wrote: a stale checkpoint must not shadow it
                ck.complete()
            return None
        if total is None:
            if builder is not None:
                builder.abort()
            return None
        if builder is not None:
            builder.finish()
        if quarantine is not None:
            quarantine.finish(counters)
        lines = self._streamed_model_lines(enc, st, total, counters, delim)
        if ck is not None:
            ck.complete()
        return lines

    def _train_warm(self, scan, enc: DatasetEncoder, st: _NBStreamState,
                    counters: Counters, delim: str,
                    quarantine=None, mesh=None) -> Optional[List[str]]:
        """The warm half of ``_train_streamed``: replay the cache
        artifact's recorded chunks off mmap, with no parse and no encode,
        through the same stream state (caps, guards, host moments,
        quarantine accounting), so every output byte equals the cold
        run's.  With the raw matrix present and ``ingest.cache.fused`` on,
        the fold ships the pre-bin integers and bins inside the count
        (``_nb_local_rawbin``); otherwise it folds the stored binned
        matrix with ``_nb_local``."""
        from ..core import ingestcache, pipeline
        from ..core.binning import ChunkedEncodeUnsupported

        tracer = get_tracer()
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
                with tracer.span("ingest.cache.read", rows=n):
                    if quarantine is not None:
                        quarantine.admit(n)
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
                    device=self.device, mesh=mesh, prefetch_depth=depth)
            else:
                total = pipeline.streaming_fold(
                    chunks(), _nb_local,
                    static_args=(st.n_class_cap, st.bins_cap),
                    device=self.device, mesh=mesh, prefetch_depth=depth)
        except ChunkedEncodeUnsupported:
            return None
        if total is None:
            return None
        if quarantine is not None:
            quarantine.finish(counters)
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

    def fold_spec(self, out_path: str):
        """This trainer's shared-scan ``core.multiscan.FoldSpec``; None in
        text mode (token streams cannot ride the tabular scan)."""
        if not self.tabular:
            return None
        return _NBFoldSpec(self, out_path)

    def train_lines(self, ds: EncodedDataset, delim: str,
                    counters: Counters, mesh=None) -> List[str]:
        """The one-shot pass: count the whole encoded dataset on the
        device, or sharded over ``mesh``, and emit reference-format
        lines."""
        n_class = len(ds.class_vocab)
        F = ds.n_features
        max_bins = max([b for b in ds.num_bins] + [1])
        cont_cols = [j for j in range(F) if not ds.binned_mask[j]]
        xs, ys = ds.x, ds.y
        if max_bins <= 127 and F <= 127:
            xs = xs.astype(np.int8)
        if n_class <= 127:
            ys = ys.astype(np.int8)
        kw = {"mesh": mesh} if mesh is not None else {"device": self.device}
        counts = sharded_reduce(_nb_local, xs, ys,
                                static_args=(n_class, max_bins),
                                **kw).cpu().numpy()
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
        self._emit_drift(ds, counts, counters, delim)
        return lines

    def _emit_drift(self, ds: EncodedDataset, counts, counters: Counters,
                    delim: str) -> None:
        """Count-distribution drift gauges: with
        ``telemetry.drift.baseline.path`` naming a previously written NB
        model, each binned feature's bin-count distribution in this fold
        (summed over classes) is diffed against the baseline's feature
        priors; the symmetrised KL divergence goes to a
        ``drift.<feature>`` gauge and, scaled by 1e6, to a ``Drift``
        counter.  A baseline that cannot be read sets ``Drift / Baseline
        load failed`` and prints one stderr line: the gauge never fails a
        finished fold."""
        base_path = self.config.get(telemetry.KEY_DRIFT_BASELINE)
        if not base_path:
            return
        try:
            baseline = load_model_feature_counts(base_path, delim)
        except Exception as e:                          # noqa: BLE001
            counters.set("Drift", "Baseline load failed", 1)
            print(f"drift: cannot load baseline {base_path!r}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return
        metrics = telemetry.get_metrics()
        for j, f in enumerate(ds.feature_fields):
            if not ds.binned_mask[j]:
                continue            # Gaussian features carry no bin table
            cur = {}
            per_bin = np.asarray(counts)[:, j, :].sum(axis=0)
            for b in range(ds.num_bins[j]):
                c = int(per_bin[b])
                if c:
                    cur[ds.bin_label(j, b)] = c
            div = telemetry.count_drift(baseline.get(f.ordinal, {}), cur)
            name = f.name or str(f.ordinal)
            metrics.set_gauge(f"drift.{name}", div)
            counters.set("Drift", f"{name} (KL x1e6)",
                         int(round(div * 1e6)))

    # -- text-classification mode -----------------------------------------
    TEXT_ORDINAL = 1   # fixed featureAttrOrdinal (BayesianDistribution.java:121)

    def _run_text(self, in_path: str, out_path: str, counters: Counters,
                  delim_in: str, delim: str, mesh=None) -> Counters:
        """``tabular.input=false``: each record is ``text<delim>classVal``;
        tokens are counted as binned feature values of ordinal 1
        (BayesianDistribution.java:187-196).  Tokenizing and the token
        vocabulary are host passes; the count is the tabular path's, one
        (token, class) row per token occurrence, so K1 runs at F = 1 with
        as many bins as the vocabulary has tokens."""
        from ..core.binning import Vocab
        from .text import standard_tokenize

        tracer = get_tracer()
        with tracer.span("phase:train"):
            vocab = Vocab()
            class_vocab = Vocab()
            tok_ids: List[int] = []
            cls_ids: List[int] = []
            for line in read_lines(in_path):
                items = split_line(line, delim_in)
                cv = class_vocab.add(items[1])
                for tok in standard_tokenize(items[0]):
                    tok_ids.append(vocab.add(tok))
                    cls_ids.append(cv)
            x = np.asarray(tok_ids, dtype=np.int32)[:, None]
            y = np.asarray(cls_ids, dtype=np.int32)
            kw = ({"mesh": mesh} if mesh is not None
                  else {"device": self.device})
            counts = sharded_reduce(
                _nb_local, x, y,
                static_args=(len(class_vocab), max(len(vocab), 1)),
                **kw).cpu().numpy()

        with tracer.span("phase:emit"):
            lines: List[str] = []
            o = self.TEXT_ORDINAL
            for c, class_val in enumerate(class_vocab.values):
                for b, tok in enumerate(vocab.values):
                    cnt = int(counts[c, 0, b])
                    if cnt == 0:
                        continue
                    counters.incr("Distribution Data",
                                  "Feature posterior binned ")
                    lines.append(f"{class_val}{delim}{o}{delim}{tok}{delim}"
                                 f"{cnt}")
                    counters.incr("Distribution Data", "Class prior")
                    lines.append(f"{class_val}{delim}{delim}{delim}{cnt}")
                    counters.incr("Distribution Data", "Feature prior binned ")
                    lines.append(f"{delim}{o}{delim}{tok}{delim}{cnt}")
            write_output(out_path, lines)
        return counters


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

    def feature_prior_prob(self, feature_values) -> float:
        """The product of the feature priors of ``(ordinal, value)``
        pairs, left to right (the text predictor's scalar path)."""
        p = 1.0
        for ordinal, v in feature_values:
            p *= self.prior[ordinal].prob(v)
        return p

    def feature_post_prob(self, class_val: str, feature_values) -> float:
        p = 1.0
        for ordinal, v in feature_values:
            p *= self.post[(class_val, ordinal)].prob(v)
        return p


class _NBFoldSpec(MultiScanFoldSpec):
    """The NB trainer's part of the shared scan: schema-encodes each chunk
    through the encoder it shares with every co-registered job on the same
    schema file (so the encode and the copy happen once a chunk), folds
    ``_nb_local`` on the device (K1 on the card), and writes the model of
    a standalone streamed run.  The fold arrays stay int32: narrowing them
    to int8 would give this job a private copy instead of the shared one.
    The fold certificate (core.algebra) holds its split invariance."""

    def __init__(self, job: "BayesianDistribution", out_path: str):
        self.job = job
        self.out_path = out_path
        self.name = type(job).__name__
        self.local_fn = _nb_local
        self.static_args: tuple = ()
        self.enc = DatasetEncoder(job.schema)
        self.delim = job.config.field_delim_out()
        self.st: Optional[_NBStreamState] = None

    def bind(self, engine) -> None:
        import os
        sp = self.job.config.get("feature.schema.file.path")
        if sp:
            self.enc = engine.shared_encoder(
                ("schema-encoder", os.path.abspath(sp)), self.enc)

    def encode(self, ctx):
        # the native encode off the raw bytes where it applies (negative
        # bins arrive unshifted and fail accept's guard; the Python
        # fallback raises on its per-chunk shift)
        x, values, y, n = ctx.encoded(self.enc)
        if n == 0:
            return None
        if self.st is None:
            self.st = _NBStreamState(self.enc)
            self.st.size_caps(x)
            self.static_args = (self.st.n_class_cap, self.st.bins_cap)
        return self.st.accept(x, values, y, n, narrow=False)

    def finalize(self, carry) -> Counters:
        counters = Counters()
        lines = self.job._streamed_model_lines(self.enc, self.st, carry,
                                               counters, self.delim)
        write_output(self.out_path, lines)
        return counters


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
        if self.tabular:
            self.schema = schema or FeatureSchema.from_file(
                config.must("feature.schema.file.path"))
        else:
            self.schema = schema
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
        elif self.schema is not None:
            card = self.schema.class_attr_field().cardinality
            self.predicting_classes = [card[0], card[1]]
        else:
            # text mode without bp.predict.class: the model's classes
            self.predicting_classes = list(self.model.class_count)[:2]

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
    def _prepare_f32(post, prior, gauss_post, gauss_prior, class_prior,
                     is_cont):
        """The float32 scorer's per-model tables, made once a model: the
        float32 bin tables and their logs (a zero clamped to 1e-30), each
        Gaussian's mean, clamped std and ``-log(std)``, and the log class
        priors.  The logs are elementwise, so a pick from a log table is
        the log of the pick, bit for bit."""
        f32 = torch.float32
        tiny = 1e-30
        post = post.to(f32)
        prior = prior.to(f32)

        def gauss(params):
            params = params.to(f32)
            std = params[..., 1].clamp_min(1e-9)
            return params[..., 0], std, -log_f32(std)
        return ((post, prior, log_f32(post.clamp_min(tiny)),
                 log_f32(prior.clamp_min(tiny)))
                + gauss(gauss_post) + gauss(gauss_prior)
                + (log_f32(class_prior.to(f32)), is_cont))

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
        so it is exact.  A server prepares the tables once
        (:meth:`_prepare_f32`) and calls :meth:`_score_prepared_f32`."""
        return BayesianPredictor._score_prepared_f32(
            x, values, *BayesianPredictor._prepare_f32(
                post, prior, gauss_post, gauss_prior, class_prior, is_cont))

    @staticmethod
    def _score_prepared_f32(x, values, post, prior, lpost, lprior,
                            gpost_mean, gpost_std, gpost_nlog, gprior_mean,
                            gprior_std, gprior_nlog, lclass_prior, is_cont,
                            feat: bool = True):
        """:meth:`_score_batch_f32` on the tables of :meth:`_prepare_f32`;
        ``feat=False`` leaves the feature probabilities out (``None``),
        for a caller that prints only the class probabilities."""
        f32 = torch.float32
        dev = x.device
        x = x.long()
        values = values.to(f32)
        n, F = x.shape
        C = post.shape[0]
        xc = x.clamp(0, post.shape[2] - 1)
        cols = torch.arange(F, device=dev)
        half_log_2pi = torch.tensor(0.5 * math.log(2.0 * math.pi), dtype=f32)

        def log_gauss(v, mean, std, nlog_std):
            z = (v - mean) / std
            # -0.5*z*z - log(std) with the multiply and the subtract in
            # one rounding, as XLA's backend contracts them
            return fma_f32(z, z * -0.5, nlog_std) - half_log_2pi

        crow = torch.arange(C, device=dev)[None, :, None]
        prior_pick = prior[cols[None, :], xc]                           # [n, F]
        post_pick = post[crow, cols[None, None, :], xc[:, None, :]]     # [n, C, F]
        lprior_f = torch.where(
            is_cont[None, :],
            log_gauss(values, gprior_mean, gprior_std, gprior_nlog),
            lprior[cols[None, :], xc])
        lfeat_prior = _sum_last(lprior_f)                               # [n]
        lpost_f = torch.where(
            is_cont[None, None, :],
            log_gauss(values[:, None, :], gpost_mean, gpost_std, gpost_nlog),
            lpost[crow, cols[None, None, :], xc[:, None, :]])
        lfeat_post = _sum_last(lpost_f)                                 # [n, C]
        lratio = lfeat_post + lclass_prior[None, :] - lfeat_prior[:, None]
        probs = _java_int32(torch.exp(lratio) * 100)
        # a true zero posterior factor must give probability 0, as the
        # float64 product does; the tiny clamp would otherwise cancel
        # against a matching zero prior factor in log space
        post_zero = ((~is_cont)[None, None, :] & (post_pick <= 0)).any(dim=2)
        prior_zero = ((~is_cont)[None, :] & (prior_pick <= 0)).any(dim=1)
        probs = torch.where(post_zero, torch.zeros_like(probs), probs)
        if not feat:
            return probs, None, None
        # the feature probabilities exponentiate in float64 (tail products
        # below ~1e-38 would flush to 0 in float32), with XLA's exp, all in
        # one call: they are printed as they are in prob-only mode
        feat = exp_f64(torch.cat([lfeat_prior[:, None], lfeat_post],
                                 dim=1).double())
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        return (probs, torch.where(prior_zero, zero, feat[:, 0]),
                torch.where(post_zero, zero, feat[:, 1:]))

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

    def score(self, records, mesh=None):
        """Encode ``records`` and score them on the device with the
        configured precision; returns ``(ds, tables, probs, feat_prior,
        feat_post)`` with host numpy results.

        With a ``mesh`` (the reference's form, ``shard_map`` over
        ``data``) the rows pad to a multiple of the ``data`` axis's size
        and each data shard is scored once, on the device of its first
        position, against that device's copy of the tables; the other
        positions of a data shard, along ``model``, would hold replicas
        and score nothing more.  The scoring is row-local, so the result,
        cut back to the records, equals the one-device result byte for
        byte."""
        from ..parallel.mesh import pad_rows, shard_rows

        ds = DatasetEncoder(self.schema).encode(records)
        tables = self._build_tables(ds)
        score_fn = (self._score_batch_f32
                    if self.score_precision == "float32"
                    else self._score_batch)
        n = ds.x.shape[0]
        if mesh is None or mesh.shape["data"] == 1:
            dev = self.device if mesh is None else mesh.devices.flat[0]
            shards = [(torch.from_numpy(ds.x).to(dev),
                       torch.from_numpy(ds.values).to(dev))]
        else:
            d = mesh.shape["data"]
            shards = zip(shard_rows(pad_rows(ds.x, d)[0], mesh),
                         shard_rows(pad_rows(ds.values, d)[0], mesh))
        tables_on = {}
        outs = []
        for x, values in shards:
            if x.device not in tables_on:
                tables_on[x.device] = predictor_tables_to_device(tables,
                                                                 x.device)
            outs.append(score_fn(x, values, *tables_on[x.device]))
        probs, feat_prior, feat_post = (
            torch.cat([o[i].cpu() for o in outs]).numpy()[:n]
            for i in range(3))
        return ds, tables, probs, feat_prior, feat_post

    def score_text(self, records):
        """Text mode (``tabular.input=false``): each record's tokens scored
        on the host through the loaded model in float64, as the reference
        scores them (the token vocabulary lives in the model text);
        returns ``(probs, feat_prior, feat_post)``."""
        from .text import standard_tokenize

        o = BayesianDistribution.TEXT_ORDINAL
        n, C = len(records), len(self.predicting_classes)
        probs = np.zeros((n, C), dtype=np.int64)
        feat_prior = np.zeros(n)
        feat_post = np.zeros((n, C))
        for i, items in enumerate(records):
            fv = [(o, t) for t in standard_tokenize(items[0])]
            feat_prior[i] = self.model.feature_prior_prob(fv)
            for ci, cv in enumerate(self.predicting_classes):
                feat_post[i, ci] = self.model.feature_post_prob(cv, fv)
                ratio = (feat_post[i, ci] * self.model.class_prior_prob(cv)
                         / max(feat_prior[i], 1e-300))
                probs[i, ci] = int(ratio * 100)
        return probs, feat_prior, feat_post

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        """Score ``in_path`` and write one prediction line per record: on
        this job's device, or with ``mesh`` one data shard of the rows on
        each device of its ``data`` axis (:meth:`score`)."""
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        raw_lines = list(read_lines(in_path))
        records = [split_line(l, delim_regex) for l in raw_lines]
        if not self.tabular:
            probs, feat_prior, feat_post = self.score_text(records)
            actuals = [items[1] for items in records]
        else:
            _, _, probs, feat_prior, feat_post = self.score(records, mesh)
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

        if not self.output_feature_prob_only and with_confusion:
            conf.to_counters(counters)
        return out
