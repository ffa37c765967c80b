"""Numerical attribute stats and the univariate Fisher linear discriminant.

The port's copy of ``avenir_tpu/models/discriminant.py``, with the same
config keys and output bytes.  Both jobs are host work: the moments are
exact float64 NumPy sums over the whole column, formatted by Python, so
they are the reference's bits by construction (no torch reduction, whose
order would differ).

- chombo's ``NumericalAttrStats`` computes per (attribute,
  condition-value) moments; condition value "0" is the unconditioned row.
  Output line: ``attr,condVal,sum,sumSq,count,mean,variance,stdDev``
  (read by ``correlation.NumericalAttrStatsManager``).
  ``NumericalAttrStats.fold_spec`` exports its host-only part of a shared
  scan (core.multiscan): each chunk's attribute columns and condition
  column, taken by the native column parser as float64 and fixed-width
  bytes, are kept, and finalize runs the same moment code over their
  concatenation; the condition values are grouped with array operations
  (``_cond_groups``), never one Python string a row.
- ``discriminant.FisherDiscriminant``: per attribute with two
  class-conditional stats, the count-weighted pooled variance, the
  log-odds prior ``log(c0/c1)`` and the decision boundary
  ``(m0+m1)/2 - logOddsPrior*pooledVar/(m0-m1)``
  (FisherDiscriminant.java:84-97); output
  ``attr,logOddsPrior,pooledVariance,discrimValue``.

Each job takes a ``device`` as every job does (``cuda:0`` unless the
caller asks for the CPU), and does no device work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..core.obs import traced_run
from ..device import resolve_device


def _cond_groups(conds: np.ndarray) -> List[Tuple[str, np.ndarray]]:
    """(condVal, row selection) of each distinct condition value of the
    array ``conds`` (text, or the native parser's fixed-width bytes), in
    the order ``sorted(set(...))`` gives the decoded text: UTF-8 bytes
    sort as their code points.  Values of one or two bytes sort as
    big-endian integers, so one ``bincount`` finds them; wider ones take
    ``np.unique``."""
    conds = np.asarray(conds)
    k = conds.dtype.itemsize
    if conds.dtype.kind == "S" and k <= 2:
        codes = conds.view(f">u{k}")
        present = np.flatnonzero(np.bincount(codes, minlength=1))
        keys = present.astype(f">u{k}").view(f"S{k}").tolist()
        return [(key.decode(), codes == v) for key, v in zip(keys, present)]
    uniq, inv = np.unique(conds, return_inverse=True)
    inv = inv.reshape(-1)
    return [(u.decode() if isinstance(u, bytes) else str(u), inv == i)
            for i, u in enumerate(uniq.tolist())]


def _moment_rows(vals: np.ndarray, groups: List[Tuple[str, np.ndarray]]
                 ) -> List[Tuple[str, np.ndarray]]:
    """(condVal, [sum, sumSq, count, mean, variance, stdDev]) rows, with the
    unconditioned "0" row first, then one row a group of ``_cond_groups``
    (``vals[sel]`` keeps the rows' order, so the sums are a row loop's)."""
    def stats(v):
        cnt = len(v)
        s = float(v.sum()); s2 = float((v * v).sum())
        mean = s / cnt
        var = s2 / cnt - mean * mean
        return np.asarray([s, s2, cnt, mean, var, math.sqrt(max(var, 0.0))])

    return [("0", stats(vals))] + [(cond, stats(vals[sel]))
                                   for cond, sel in groups]


def _stats_lines(attrs: List[int], vals_by_attr, conds: np.ndarray,
                 delim: str) -> List[str]:
    """NumericalAttrStats output lines from per-attribute value arrays and
    the condition column as an array (shared by the standalone job and the
    shared-scan FoldSpec)."""
    groups = _cond_groups(conds)
    out = []
    for a in attrs:
        for cond, row in _moment_rows(np.asarray(vals_by_attr[a]), groups):
            body = delim.join(str(v) for v in row)
            out.append(f"{a}{delim}{cond}{delim}{body}")
    return out


class NumericalAttrStats:
    """Per-attribute (optionally class-conditioned) moment stats job."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        attrs = [int(v) for v in cfg.must_list("attr.list")]
        cond_ord = cfg.get_int("cond.attr.ord", -1)

        records = [split_line(l, cfg.field_delim_regex())
                   for l in read_lines(in_path)]
        vals_by_attr = {a: np.asarray([float(r[a]) for r in records])
                        for a in attrs}
        conds = np.asarray([r[cond_ord] for r in records] if cond_ord >= 0
                           else ["0"] * len(records), dtype=str)
        write_output(out_path, _stats_lines(attrs, vals_by_attr, conds,
                                            delim))
        counters.set("Stats", "Attributes", len(attrs))
        return counters

    def fold_spec(self, out_path: str):
        """This job's shared-scan ``core.multiscan.FoldSpec`` (host-only:
        the float moments stay on the host)."""
        return _StatsFoldSpec(self, out_path)


class _StatsFoldSpec(MultiScanFoldSpec):
    """NumericalAttrStats' host-only part of the shared scan: each chunk's
    attribute columns parse to float64 and its condition column stays the
    parser's fixed-width bytes (a few columns, small beside the input the
    scan no longer re-reads); finalize concatenates them and emits through
    ``_stats_lines``, the standalone job's code, so the sums run over the
    same whole array and the output is the same.  No Python object is
    made per row.  The fold certificate (core.algebra) holds its split
    invariance."""

    local_fn = None

    def __init__(self, job: NumericalAttrStats, out_path: str):
        cfg = job.config
        self.job = job
        self.out_path = out_path
        self.name = type(job).__name__
        self.attrs = [int(v) for v in cfg.must_list("attr.list")]
        self.cond_ord = cfg.get_int("cond.attr.ord", -1)
        self.delim = cfg.field_delim_out()
        self._vals: Dict[int, list] = {a: [] for a in self.attrs}
        self._conds: List[np.ndarray] = []

    def encode(self, ctx):
        cols = self._native_columns(ctx)
        if cols is not None:
            n, vals, conds = cols
        else:
            n, vals, conds = self._field_columns(ctx.fields())
        if n == 0:
            return None
        for a in self.attrs:
            self._vals[a].append(vals[a])
        self._conds.append(conds if conds is not None
                           else np.full(n, b"0", dtype="S1"))
        return ()   # host-only: chunk consumed, nothing to fold

    def _native_columns(self, ctx):
        """(n, {attr: float64 array}, cond bytes array or None) by the
        native column parser (C ``strtod``: the values ``float()`` gives),
        or None to fall back to the field matrix."""
        from .. import native

        want = list(self.attrs)
        kinds = [native.FLOAT64] * len(want)
        if self.cond_ord >= 0:
            if self.cond_ord in want:
                return None            # duplicate ordinal: one kind each
            want.append(self.cond_ord)
            kinds.append(native.BYTES)
        cols = ctx.columns(tuple(want), tuple(kinds))
        if cols is None:
            return None
        n = len(cols[self.attrs[0]]) if self.attrs else 0
        vals = {a: cols[a] for a in self.attrs}
        return n, vals, cols.get(self.cond_ord)

    def _field_columns(self, chunk):
        """The same from the chunk's fields (a field matrix, or per-line
        field lists where the chunk is ragged), the condition column
        encoded to UTF-8 bytes."""
        if isinstance(chunk, np.ndarray) and chunk.ndim == 2:
            n = chunk.shape[0]
            vals = {a: chunk[:, a].astype(np.float64) for a in self.attrs}
            conds = chunk[:, self.cond_ord] if self.cond_ord >= 0 else None
        else:
            n = len(chunk)
            vals = {a: np.asarray([float(r[a]) for r in chunk])
                    for a in self.attrs}
            conds = (np.asarray([r[self.cond_ord] for r in chunk], dtype=str)
                     if self.cond_ord >= 0 else None)
        if conds is not None:
            conds = np.char.encode(conds, "utf-8")
        return n, vals, conds

    def finalize(self, carry) -> Counters:
        counters = Counters()
        vals_by_attr = {
            a: (np.concatenate(v) if v else np.zeros(0))
            for a, v in self._vals.items()}
        conds = (np.concatenate(self._conds) if self._conds
                 else np.zeros(0, dtype="S1"))
        write_output(self.out_path, _stats_lines(
            self.attrs, vals_by_attr, conds, self.delim))
        counters.set("Stats", "Attributes", len(self.attrs))
        return counters


class FisherDiscriminant:
    """Univariate Fisher discriminant job (reuses the stats computation the
    way the reference reuses chombo's NumericalAttrStats)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        attrs = [int(v) for v in cfg.must_list("attr.list")]
        cond_ord = cfg.must_int("cond.attr.ord")

        records = [split_line(l, cfg.field_delim_regex())
                   for l in read_lines(in_path)]
        groups = _cond_groups(np.asarray([r[cond_ord] for r in records],
                                         dtype=str))

        out = []
        for a in attrs:
            vals = np.asarray([float(r[a]) for r in records])
            rows = _moment_rows(vals, groups)
            # the stats lines (NumericalAttrStats' output, emitted by the
            # shared reducer path in the reference)
            for cond, row in rows:
                body = delim.join(str(v) for v in row)
                out.append(f"{a}{delim}{cond}{delim}{body}")
            # the two class-conditional rows in sorted-value order: the MR
            # shuffle delivers keys sorted, so c0/c1 follow the sorted
            # class values (flipping them would negate logOddsPrior)
            cls = [(cond, row) for cond, row in rows if cond != "0"]
            if len(cls) != 2:
                raise ValueError(
                    f"FisherDiscriminant needs exactly 2 class values, "
                    f"got {[c for c, _ in cls]}")
            (c0, r0), (c1, r1) = cls
            cnt0, m0, v0 = r0[2], r0[3], r0[4]
            cnt1, m1, v1 = r1[2], r1[3], r1[4]
            pooled_var = (v0 * cnt0 + v1 * cnt1) / (cnt0 + cnt1)
            log_odds_prior = math.log(cnt0 / cnt1)
            mean_diff = m0 - m1
            discrim = (m0 + m1) / 2 - log_odds_prior * pooled_var / mean_diff
            out.append(f"{a}{delim}{log_odds_prior}{delim}{pooled_var}"
                       f"{delim}{discrim}")
            counters.incr("Fisher", "Attributes")
        write_output(out_path, out)
        return counters
