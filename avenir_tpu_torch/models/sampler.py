"""Sampling jobs: batch bootstrap (bagging) and majority undersampling.

Reference surface:
- ``explore.BaggingSampler`` — buffers ``batch.size`` rows, emits batchSize
  uniform with-replacement draws per batch including the final partial batch
  (BaggingSampler.java:76-124).
- ``explore.UnderSamplingBalancer`` — estimates the class distribution from
  the first ``distr.batch.size`` rows, then emits majority-class rows with
  probability minClassCount/classCount (running counts), minority rows
  always (UnderSamplingBalancer.java:74-160).

The reference uses unseeded ``Math.random()``; both packages draw from
numpy's seeded generator (``sampling.seed`` key), so runs are reproducible
and the port's copy writes the reference package's bytes.  Each job takes a
``device`` and resolves it, as the port's other jobs do, though neither
does device work.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.config import JobConfig
from ..core.obs import traced_run
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..device import resolve_device


class BaggingSampler:
    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        batch_size = cfg.get_int("batch.size", 10000)
        rng = np.random.default_rng(cfg.get_int("sampling.seed", 0))

        lines = list(read_lines(in_path))
        out: List[str] = []
        for start in range(0, len(lines), batch_size):
            batch = lines[start:start + batch_size]
            picks = rng.integers(0, len(batch), len(batch))
            out.extend(batch[i] for i in picks)
        write_output(out_path, out)
        counters.set("Sampling", "Emitted", len(out))
        return counters


class UnderSamplingBalancer:
    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        class_ord = cfg.must_int("class.attr.ord")
        distr_batch = cfg.get_int("distr.batch.size", 500)
        rng = np.random.default_rng(cfg.get_int("sampling.seed", 0))

        lines = list(read_lines(in_path))
        class_counts: dict = {}
        buffered: List[str] = []
        out: List[str] = []

        def emit(line: str, cls: str) -> None:
            cnt = class_counts[cls]
            mn = min(class_counts.values())
            if cnt > mn:
                if rng.random() < mn / cnt:
                    out.append(line)
            else:
                out.append(line)

        for row_num, line in enumerate(lines, start=1):
            cls = split_line(line, delim_regex)[class_ord]
            class_counts[cls] = class_counts.get(cls, 0) + 1
            if row_num < distr_batch:
                buffered.append(line)
            elif row_num == distr_batch:
                for b in buffered:
                    emit(b, split_line(b, delim_regex)[class_ord])
                buffered.clear()
                emit(line, cls)
            else:
                emit(line, cls)
        # input smaller than the bootstrap batch: flush everything
        for b in buffered:
            emit(b, split_line(b, delim_regex)[class_ord])
        write_output(out_path, out)
        counters.set("Sampling", "Emitted", len(out))
        return counters
