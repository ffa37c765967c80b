"""Iterative batch logistic regression.

Reference surface (citations into the Java avenir sources):
- ``org.avenir.regress.LogisticRegressionJob`` — one MR pass per iteration:
  mapper loads the LAST line of the coefficient-history file
  (``coeff.file.path``, one line per iteration; LogisticRegressionJob.java:154-160),
  parses the feature columns as ints with a constant-1 bias prepended
  (:182-191), and aggregates per-record gradient contributions; the reducer
  sums partial aggregates, writes the new coefficient line to the job output,
  and APPENDS it to the history file (:220-255).  The driver then checks
  convergence and returns CONVERGED(100)/NOT_CONVERGED(101) so an outer loop
  can re-run (:95-119, main :279-289).
- ``org.avenir.regress.LogisticRegressor`` — the gradient:
  ``agg += x * (y - sigmoid(w.x))`` (LogisticRegressor.java:61-73), and the
  convergence measures over the percent relative change between consecutive
  coefficient lines: all-below-threshold and average-below-threshold
  (:105-163).

Reference-parity note: the reference's "new coefficients" ARE the raw
gradient aggregates — the reducer saves ``regressor.getAggregates()``
verbatim with no learning-rate step (LogisticRegressionJob.java:220-230), a
fixed-point iteration rather than gradient ascent.  We reproduce that by
default so history files and convergence behavior match.  Setting
``learning.rate`` (no reference equivalent) switches to the standard ascent
update ``w' = w + lr * agg / n`` — the numerically sane mode for new users.

The port's counterpart of ``avenir_tpu/models/regress.py``, with the same
config keys, history file and exit statuses.  The row batch is parsed
once and stays on the job's device across iterations; an iteration is
two float64 products, ``z = X w`` and ``X^T (y - sigmoid(z))``, on that
device, or on each data shard of a mesh with the shards' gradients summed
(the reference's ``psum``).  TF32 never touches float64 products, so the
reference's HIGHEST-precision request has nothing to carry over.  The
gradient equals the reference's within rounding (the products' order of
summation and ``exp`` differ in the last bits), the tolerance its own
tests hold it to against a NumPy oracle (``rtol=1e-9``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.config import JobConfig
from ..core.io import (atomic_write_text, read_lines, split_line,
                       write_output)
from ..core.metrics import Counters
from ..core.obs import traced_run
from ..core.schema import FeatureSchema
from ..device import resolve_device
from ..parallel.mesh import pad_rows

CONVERGED = 100
NOT_CONVERGED = 101

ITER_LIMIT = "iterLimit"
ALL_BELOW_THRESHOLD = "allBelowThreshold"
AVERAGE_BELOW_THRESHOLD = "averageBelowThreshold"


class LogisticRegressor:
    """Host-side convergence math (LogisticRegressor.java:105-163)."""

    def __init__(self, coefficients: np.ndarray, aggregates: np.ndarray):
        self.coefficients = np.asarray(coefficients, dtype=np.float64)
        self.aggregates = np.asarray(aggregates, dtype=np.float64)

    def coeff_diff(self) -> np.ndarray:
        """|(new - old) * 100 / old| per coefficient.

        A coefficient that is exactly 0 in the previous line (the natural
        all-zero starting point) would make the reference formula divide by
        zero and never converge; treat 0 -> 0 as 0% change and 0 -> nonzero
        as infinite change so thresholds behave sensibly.
        """
        with np.errstate(divide="ignore", invalid="ignore"):
            diff = np.abs((self.aggregates - self.coefficients) * 100.0
                          / self.coefficients)
        both_zero = (self.coefficients == 0.0) & (self.aggregates == 0.0)
        return np.where(both_zero, 0.0, diff)

    def is_all_converged(self, threshold: float) -> bool:
        return bool(np.all(self.coeff_diff() <= threshold))

    def is_average_converged(self, threshold: float) -> bool:
        return bool(self.coeff_diff().mean() < threshold)


def _gradient(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """One shard's gradient aggregate ``x^T (y - sigmoid(x w))`` in float64
    (the mapper's hot loop; LogisticRegressor.java:61-73); rows where
    ``mask`` is False add nothing."""
    p = 1.0 / (1.0 + torch.exp(-(x @ w)))
    return x.T @ torch.where(mask, y - p, torch.zeros((), dtype=p.dtype,
                                                      device=p.device))


class LogisticRegressionJob:
    """One logistic-regression iteration + convergence check; ``run_loop``
    mirrors the reference driver's do-while (LogisticRegressionJob.java:279-289)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.schema = FeatureSchema.from_file(config.must("feature.schema.file.path"))
        self.device = resolve_device(device)
        self.counters = Counters()
        # device-resident batch, loaded lazily and reused across iterations
        self._resident = None
        self._resident_path = None

    # -- history file -------------------------------------------------------
    def _read_history(self) -> List[str]:
        path = self.config.must("coeff.file.path")
        return [l for l in read_lines(path)]

    def _write_history(self, lines: List[str]) -> None:
        # the coefficient history drives iterative restart (README
        # "Failure recovery"): atomic replace, so a crash mid-iteration
        # leaves the previous complete history, never a torn file
        atomic_write_text(self.config.must("coeff.file.path"),
                          "".join(line + "\n" for line in lines))

    # -- data ---------------------------------------------------------------
    def _load(self, in_path: str, mesh=None):
        if self._resident is not None and self._resident_path == in_path:
            return self._resident
        delim = self.config.field_delim_regex()
        ords = [f.ordinal for f in self.schema.feature_fields()]
        class_ord = self.schema.class_attr_field().ordinal
        pos_val = self.config.must("positive.class.value")

        xs, ys = [], []
        for line in read_lines(in_path):
            items = split_line(line, delim)
            # bias term first, features parsed as ints
            # (LogisticRegressionJob.java:184-191)
            xs.append([1] + [int(items[o]) for o in ords])
            ys.append(1.0 if items[class_ord] == pos_val else 0.0)
        x = np.asarray(xs, dtype=np.float64)
        y = np.asarray(ys, dtype=np.float64)

        if mesh is None:
            # one shard on the job's device
            shards = [tuple(torch.from_numpy(a).to(self.device)
                            for a in (x, y, np.ones(len(y), dtype=bool)))]
        else:
            # row shards over the mesh's data axis, as the reference's
            from ..parallel.mesh import shard_rows
            d = mesh.shape["data"]
            x, mask = pad_rows(x, d)
            y, _ = pad_rows(y, d)
            shards = list(zip(*(shard_rows(a, mesh, "data")
                                for a in (x, y, mask))))
        self._resident = (shards, x.shape[1], int(len(ys)))
        self._resident_path = in_path
        return self._resident

    @staticmethod
    def _aggregate(shards, coeff: np.ndarray) -> np.ndarray:
        """The gradient aggregate over every shard, summed left to right
        on the first shard's device (the reference's ``psum``)."""
        from ..parallel.mesh import psum
        parts = [_gradient(x, y, m, torch.from_numpy(coeff).to(x.device))
                 for x, y, m in shards]
        return psum(parts)[0].cpu().numpy()

    # -- one iteration ------------------------------------------------------
    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> int:
        cfg = self.config
        delim = cfg.field_delim_out()
        history = self._read_history()
        if not history:
            raise ValueError("coeff.file.path must hold the initial "
                             "coefficient line (bias first, one per feature)")
        coeff = np.asarray(
            [float(v) for v in split_line(history[-1], cfg.field_delim_regex())])

        shards, width, n = self._load(in_path, mesh)
        if coeff.shape[0] != width:
            raise ValueError(
                f"coefficient line has {coeff.shape[0]} values; expected "
                f"{width} (bias + feature fields)")
        grad = self._aggregate(shards, coeff)

        lr = cfg.get_float("learning.rate", None)
        if lr is None:
            # reference parity: the aggregates ARE the next line
            new_coeff = grad
        else:
            new_coeff = coeff + lr * grad / n

        line = delim.join(repr(float(v)) for v in new_coeff)
        history.append(line)
        self._write_history(history)
        write_output(out_path, [line])
        self.counters.incr("Regression", "Iterations")
        return self._check_convergence(history)

    def _check_convergence(self, history: List[str]) -> int:
        cfg = self.config
        criteria = cfg.get("convergence.criteria", ITER_LIMIT)
        if criteria == ITER_LIMIT:
            limit = cfg.get_int("iteration.limit", 10)
            return NOT_CONVERGED if len(history) < limit else CONVERGED
        prev = np.asarray([float(v) for v in
                           split_line(history[-2], cfg.field_delim_regex())])
        cur = np.asarray([float(v) for v in
                          split_line(history[-1], cfg.field_delim_regex())])
        reg = LogisticRegressor(prev, cur)
        threshold = cfg.get_float("convergence.threshold", 5.0)
        if criteria == ALL_BELOW_THRESHOLD:
            return CONVERGED if reg.is_all_converged(threshold) else NOT_CONVERGED
        if criteria == AVERAGE_BELOW_THRESHOLD:
            return (CONVERGED if reg.is_average_converged(threshold)
                    else NOT_CONVERGED)
        raise ValueError(f"Invalid convergence criteria:{criteria}")

    # -- the outer do-while (reference main) --------------------------------
    def run_loop(self, in_path: str, out_path: str,
                 max_iterations: Optional[int] = None) -> int:
        # finite default bound: a threshold criterion that never fires (e.g.
        # a coefficient stuck at +/-inf percent change) must not spin forever;
        # an iterLimit run keeps its full configured budget even past the cap
        if max_iterations is None:
            max_iterations = self.config.get_int("max.iterations", 1000)
            criteria = self.config.get("convergence.criteria", ITER_LIMIT)
            if criteria == ITER_LIMIT:
                max_iterations = max(max_iterations,
                                     self.config.get_int("iteration.limit", 10))
        status = NOT_CONVERGED
        it = 0
        while status == NOT_CONVERGED:
            status = self.run(in_path, out_path)
            it += 1
            if it >= max_iterations:
                break
        return status
