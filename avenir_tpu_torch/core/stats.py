"""Small statistics helpers (the port's copy of ``avenir_tpu/core/stats.py``)
— equivalents of the chombo utility classes the
reference's reinforcement-learning family depends on (SURVEY §2.0: chombo is
an external pom dependency, not vendored; its surface is implicit spec).

Reference usage sites:
- ``SimpleStat`` / ``AverageValue``: running reward means
  (reinforce/RandomGreedyLearner.java:49, ReinforcementLearner.java:41).
- ``CategoricalSampler``: probability-weighted action sampling
  (reinforce/SoftMaxLearner.java:36, ActionPursuitLearner.java:34,
  ExponentialWeightLearner.java:34, RewardComparisonLearner.java:36).
- ``HistogramStat``: binned reward distribution with confidence bounds
  (reinforce/IntervalEstimatorLearner.java:43,64,118).

All sampling takes an explicit ``numpy.random.Generator`` — the reference
uses global ``Math.random()``; seeded generators make runs reproducible
(SURVEY §7.3 item 5: statistical, not bitwise, equivalence).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class AverageValue:
    """Running (count, sum) -> average (chombo AverageValue)."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0

    def add(self, value: float) -> None:
        self.count += 1
        self.sum += value

    def get_avg_value(self) -> float:
        return self.sum / self.count if self.count else 0.0


class SimpleStat(AverageValue):
    """Running mean/variance (chombo SimpleStat; only the mean is consumed
    by the learners)."""

    def __init__(self):
        super().__init__()
        self.sum_sq = 0.0

    def add(self, value: float) -> None:
        super().add(value)
        self.sum_sq += value * value

    def get_std_dev(self) -> float:
        if self.count < 2:
            return 0.0
        var = self.sum_sq / self.count - self.get_avg_value() ** 2
        return float(np.sqrt(max(var, 0.0)))


class CategoricalSampler:
    """Probability-weighted sampling over string keys (chombo
    CategoricalSampler: initialize/add/get/set/sample)."""

    def __init__(self):
        self._keys: List[str] = []
        self._probs: Dict[str, float] = {}

    def initialize(self) -> None:
        self._keys = []
        self._probs = {}

    def add(self, key: str, prob: float) -> None:
        if key not in self._probs:
            self._keys.append(key)
        self._probs[key] = prob

    def get(self, key: str) -> float:
        return self._probs[key]

    def set(self, key: str, prob: float) -> None:
        self.add(key, prob)

    def sample(self, rng: np.random.Generator) -> str:
        probs = np.asarray([self._probs[k] for k in self._keys], dtype=float)
        total = probs.sum()
        if total <= 0:
            return self._keys[int(rng.integers(len(self._keys)))]
        return self._keys[int(rng.choice(len(self._keys), p=probs / total))]


class HistogramStat:
    """Binned value distribution with confidence bounds (chombo
    HistogramStat as consumed by IntervalEstimatorLearner.java:118).

    ``get_confidence_bounds(pct)`` returns the tightest ``[low, high]`` value
    range (bin-edge granularity) that covers at least ``pct`` percent of the
    sample mass, trimming equal tail mass from both ends.
    """

    def __init__(self, bin_width: int):
        self.bin_width = bin_width
        self.bins: Dict[int, int] = {}
        self.count = 0

    def add(self, value: float) -> None:
        b = int(value // self.bin_width)
        self.bins[b] = self.bins.get(b, 0) + 1
        self.count += 1

    def get_count(self) -> int:
        return self.count

    def get_confidence_bounds(self, confidence_pct: float) -> Tuple[int, int]:
        if not self.bins:
            return (0, 0)
        items = sorted(self.bins.items())
        counts = np.asarray([c for _, c in items], dtype=float)
        cum = np.cumsum(counts) / self.count
        tail = (1.0 - confidence_pct / 100.0) / 2.0
        lo_i = int(np.searchsorted(cum, tail, side="right"))
        hi_i = int(np.searchsorted(cum, 1.0 - tail, side="left"))
        hi_i = min(hi_i, len(items) - 1)
        lo_bin = items[min(lo_i, len(items) - 1)][0]
        hi_bin = items[hi_i][0]
        return (lo_bin * self.bin_width, (hi_bin + 1) * self.bin_width)
