"""Correlation jobs: Cramer index, heterogeneity reduction, numerical Pearson.

The port's counterpart of ``avenir_tpu/models/correlation.py``, with the
same config keys and output bytes:

- ``CramerCorrelation`` and ``HeterogeneityReductionCorrelation`` encode
  each configured (source, dest) categorical attribute pair to
  cardinality indices on the host and count every pair's contingency
  matrix with one ``count_table`` on the job's device (or summed over a
  mesh, ``sharded_reduce(mesh=)``); the statistic (Cramer index,
  concentration or uncertainty coefficient) is host NumPy in float64, a
  copy of the reference's;
- ``NumericalCorrelation`` (prefix ``nco``) is Pearson over configured
  ordinal pairs with host moments, or the means and deviations of a stats
  file (``NumericalAttrStatsManager``); it does no device work.

Both categorical correlations export their part of a shared scan
(core.multiscan) through ``fold_spec``: ``_CatCorrFoldSpec`` takes the
pairs' columns with the native column parser, folds the contingency
tables on the device and applies the job's statistic at finalize; it is
Cramer's only streamed path.  Not ported yet: ``parse_output`` (the DAG's
artifact import), which waits for ``core/dag.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..core.obs import traced_run
from ..core.schema import FeatureSchema
from ..device import resolve_device
from ..ops.counting import count_table, sharded_reduce


# ---------------------------------------------------------------------------
# ContingencyMatrix math (util/ContingencyMatrix.java)
# ---------------------------------------------------------------------------

def cramer_index(table: np.ndarray) -> float:
    t = np.asarray(table, dtype=np.float64)
    row = t.sum(axis=1)
    col = t.sum(axis=0)
    row[row == 0] = 1
    col[col == 0] = 1
    pearson = float((t * t / (row[:, None] * col[None, :])).sum()) - 1.0
    return pearson / (min(t.shape) - 1)


def concentration_coeff(table: np.ndarray) -> float:
    t = np.asarray(table, dtype=np.float64)
    total = t.sum()
    row = t.sum(axis=1); col = t.sum(axis=0)
    row[row == 0] = 1; col[col == 0] = 1
    rown = row / total; coln = col / total
    e = t / total
    sum_one = float(((e * e).sum(axis=1) / rown).sum())
    sum_two = float((coln * coln).sum())
    return (sum_one - sum_two) / (1.0 - sum_two)


def uncertainty_coeff(table: np.ndarray) -> float:
    t = np.asarray(table, dtype=np.float64)
    total = t.sum()
    row = t.sum(axis=1); col = t.sum(axis=0)
    row[row == 0] = 1; col[col == 0] = 1
    rown = row / total; coln = col / total
    e = t / total
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = e * np.log10(e * coln[None, :] / rown[:, None])
    # DELIBERATE deviation: the reference's dense int[][] table hits
    # 0 * log10(0) = NaN on any never-co-occurring value pair and outputs
    # NaN (ContingencyMatrix.java:165-185); we skip zero cells (the standard
    # convention, and what its own MI job does for unobserved cells) so the
    # coefficient stays finite
    sum_one = float(np.nansum(np.where(e > 0, terms, 0.0)))
    sum_two = float((coln * np.log10(coln)).sum())
    return sum_one / sum_two


def _cat_corr_local(src, dst, mask, sizes, out=None):
    """Every pair's contingency matrix ``C[pair, src, dst]``; ``src`` and
    ``dst`` are the ``[n, pairs]`` cardinality indices.  With ``out`` (a
    streamed fold's carry) the counts are added into it in place."""
    p_idx = torch.arange(src.shape[1], device=src.device)[None, :]
    m = None if mask is None else mask[:, None]
    counts = count_table(sizes, (p_idx, src, dst), mask=m)
    if out is None:
        return counts
    out += counts
    return out


def _encode_pairs_from_cols(cols, n, pairs, card):
    """(src_idx, dst_idx) int32 [n, n_pairs] cardinality indices from
    per-ordinal value columns (str or bytes arrays): one ``np.unique`` and
    lookup table per distinct ordinal.  An attribute value outside the
    declared cardinality raises KeyError, as a per-record lookup would."""
    idx = {}
    for o, col in cols.items():
        uniq, inv = np.unique(col, return_inverse=True)
        lut = np.asarray(
            [card[o][u.decode() if isinstance(u, bytes) else str(u)]
             for u in uniq.tolist()], dtype=np.int32)
        idx[o] = lut[inv.reshape(-1)]
    if not pairs:
        return (np.zeros((n, 0), np.int32), np.zeros((n, 0), np.int32))
    src_idx = np.stack([idx[s] for s, _ in pairs], axis=1)
    dst_idx = np.stack([idx[d] for _, d in pairs], axis=1)
    return src_idx, dst_idx


def _encode_pair_columns(records, pairs, card):
    """``_encode_pairs_from_cols`` over parsed records (a field matrix or
    per-line field lists)."""
    ords = sorted({o for p in pairs for o in p})
    if isinstance(records, np.ndarray) and records.ndim == 2:
        cols = {o: records[:, o] for o in ords}
        n = records.shape[0]
    else:
        cols = {o: np.asarray([r[o] for r in records], dtype=str)
                for o in ords}
        n = len(records)
    return _encode_pairs_from_cols(cols, n, pairs, card)


class CategoricalCorrelation:
    """Shared contingency-matrix job; subclasses choose the statistic."""

    stat_name = "cramer"

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)

    def statistic(self, table: np.ndarray) -> float:
        return cramer_index(table)

    def _pair_setup(self):
        """(pairs, fields, card, sizes) from the configured source/dest
        attribute lists."""
        cfg = self.config
        src_attrs = [int(v) for v in cfg.must_list("source.attributes")]
        dst_attrs = [int(v) for v in cfg.must_list("dest.attributes")]
        pairs: List[Tuple[int, int]] = [
            (s, d) for s in src_attrs for d in dst_attrs if s != d]
        fields = {o: self.schema.field_by_ordinal(o)
                  for o in set(src_attrs) | set(dst_attrs)}
        card = {o: {v: i for i, v in enumerate(fields[o].cardinality)}
                for o in fields}
        max_card = max(len(c) for c in card.values())
        sizes = (len(pairs), max_card, max_card)
        return pairs, fields, card, sizes

    def _emit_lines(self, counts, pairs, fields, card, delim) -> List[str]:
        out = []
        for p, (s, d) in enumerate(pairs):
            tbl = counts[p, :len(card[s]), :len(card[d])]
            out.append(f"{fields[s].name}{delim}{fields[d].name}{delim}"
                       f"{self.statistic(tbl)}")
        return out

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        pairs, fields, card, sizes = self._pair_setup()

        records = [split_line(l, cfg.field_delim_regex())
                   for l in read_lines(in_path)]
        src_idx, dst_idx = _encode_pair_columns(records, pairs, card)

        kw = {"mesh": mesh} if mesh is not None else {"device": self.device}
        counts = sharded_reduce(_cat_corr_local, src_idx, dst_idx,
                                static_args=(sizes,), **kw).cpu().numpy()

        write_output(out_path,
                     self._emit_lines(counts, pairs, fields, card, delim))
        counters.set("Correlation", "Pairs", len(pairs))
        return counters

    def fold_spec(self, out_path: str):
        """This job's shared-scan ``core.multiscan.FoldSpec``."""
        return _CatCorrFoldSpec(self, out_path)

    @staticmethod
    def parse_output(lines, delim: str = ","
                     ) -> List[Tuple[str, str, float]]:
        """``(src_name, dst_name, statistic)`` triples out of this job
        family's output lines: the artifact import of a workflow stage
        (core.dag).  A malformed line raises ValueError naming it, so a
        truncated artifact never yields a shorter result."""
        out = []
        for line in lines:
            parts = line.split(delim)
            try:
                if len(parts) != 3:
                    raise ValueError
                out.append((parts[0], parts[1], float(parts[2])))
            except ValueError:
                raise ValueError(
                    f"malformed correlation output line (want "
                    f"src{delim}dst{delim}statistic): {line!r}") from None
        return out


class CramerCorrelation(CategoricalCorrelation):
    pass


class HeterogeneityReductionCorrelation(CategoricalCorrelation):
    """gini -> concentration coefficient, else uncertainty coefficient
    (HeterogeneityReductionCorrelation.java:71-90)."""

    def statistic(self, table: np.ndarray) -> float:
        alg = self.config.get("heterogeneity.algorithm", "gini")
        if alg == "gini":
            return concentration_coeff(table)
        return uncertainty_coeff(table)


class _CatCorrFoldSpec(MultiScanFoldSpec):
    """The contingency-matrix correlations' part of the shared scan (the
    statistic stays the job's): each chunk's configured attribute pairs
    encode to cardinality indices and fold one ``count_table``; finalize
    applies the job's statistic to each pair's matrix.  A value outside
    the declared cardinality withdraws the spec, and the standalone
    re-run raises the KeyError a standalone job would.  The fold
    certificate (core.algebra) holds its split invariance."""

    def __init__(self, job: CategoricalCorrelation, out_path: str):
        self.job = job
        self.out_path = out_path
        self.name = type(job).__name__
        self.local_fn = _cat_corr_local
        self.delim = job.config.field_delim_out()
        self.pairs, self.fields, self.card, sizes = job._pair_setup()
        self.static_args = (sizes,)

    def encode(self, ctx):
        from ..core.binning import ChunkedEncodeUnsupported

        ords = tuple(sorted({o for p in self.pairs for o in p}))
        cols = ctx.columns(ords)
        try:
            if cols is not None:
                n = len(next(iter(cols.values()))) if cols else 0
                if n == 0:
                    return None
                return _encode_pairs_from_cols(cols, n, self.pairs,
                                               self.card)
            chunk = ctx.fields()
            n = (chunk.shape[0] if isinstance(chunk, np.ndarray)
                 else len(chunk))
            if n == 0:
                return None
            return _encode_pair_columns(chunk, self.pairs, self.card)
        except KeyError as exc:
            raise ChunkedEncodeUnsupported(
                f"undeclared attribute value {exc}")

    def finalize(self, carry) -> Counters:
        counters = Counters()
        write_output(self.out_path, self.job._emit_lines(
            np.asarray(carry), self.pairs, self.fields, self.card,
            self.delim))
        counters.set("Correlation", "Pairs", len(self.pairs))
        return counters


class NumericalCorrelation:
    """Pearson over configured ordinal pairs; config prefix ``nco``.

    The reference pulls means/stddevs from a chombo stats file
    (``stats.file.path``); when absent we compute them from the data in the
    same pass (exact host moments, as in models.bayesian).
    """

    def __init__(self, config: JobConfig, device=None):
        self.config = config.with_prefix("nco") if not config.prefix else config
        # host NumPy only; the device is resolved as every job's is
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        # "0:1,2:3" style pair list
        pair_spec = cfg.must("attr.pairs")
        pairs = []
        for item in pair_spec.replace(";", ",").split(","):
            a, b = item.split(":")
            pairs.append((int(a), int(b)))

        records = [split_line(l, cfg.field_delim_regex())
                   for l in read_lines(in_path)]
        ords = sorted({o for p in pairs for o in p})
        vals = np.asarray([[float(r[o]) for o in ords] for r in records])
        col = {o: i for i, o in enumerate(ords)}

        stats_path = cfg.get("stats.file.path")
        if stats_path:
            mgr = NumericalAttrStatsManager(stats_path, delim)
            mean = {o: mgr.mean(o) for o in ords}
            std = {o: mgr.std_dev(o) for o in ords}
        else:
            mean = {o: float(vals[:, col[o]].mean()) for o in ords}
            std = {o: float(vals[:, col[o]].std()) for o in ords}

        out = []
        for a, b in pairs:
            ca = vals[:, col[a]] - mean[a]
            cb = vals[:, col[b]] - mean[b]
            corr = float((ca * cb).mean()) / (std[a] * std[b])
            out.append(f"{a}{delim}{b}{delim}{corr}")
        write_output(out_path, out)
        counters.set("Correlation", "Pairs", len(pairs))
        return counters


class NumericalAttrStatsManager:
    """Reader for the stats file of chombo's ``NumericalAttrStats``
    (``models.discriminant``, which writes it)."""

    def __init__(self, path: str, delim: str = ","):
        self.stats = {}
        for line in read_lines(path):
            items = line.split(delim)
            # attr, condVal, sum, sumSq, count, mean, variance, stdDev
            self.stats[(int(items[0]), items[1])] = [float(v) for v in items[2:]]

    def _row(self, attr: int, cond: str = "0"):
        return self.stats[(attr, cond)]

    def mean(self, attr: int, cond: str = "0") -> float:
        return self._row(attr, cond)[3]

    def variance(self, attr: int, cond: str = "0") -> float:
        return self._row(attr, cond)[4]

    def std_dev(self, attr: int, cond: str = "0") -> float:
        return self._row(attr, cond)[5]

    def count(self, attr: int, cond: str = "0") -> int:
        return int(self._row(attr, cond)[2])
