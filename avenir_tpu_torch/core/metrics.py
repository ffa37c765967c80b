"""Job counters and validation helpers: the port's copy of
``avenir_tpu/core/metrics.py``.

- :class:`Counters`: grouped named counters, the metric channel every
  job returns and the CLI prints to stderr;
- :class:`ConfusionMatrix`: binary confusion counts with integer percent
  accuracy, recall and precision;
- :class:`CostBasedArbitrator`: misclassification-cost argmin between
  two classes.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, Tuple

from . import sanitizer


class Counters:
    """Grouped named counters; thread-safe (the chunk producer and the
    fold may run on different threads)."""

    def __init__(self):
        self._groups: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self._lock = sanitizer.make_lock("core.counters")

    def incr(self, group: str, name: str, amount: int = 1) -> None:
        with self._lock:
            self._groups[group][name] += int(amount)

    def set(self, group: str, name: str, value: int) -> None:
        with self._lock:
            self._groups[group][name] = int(value)

    def get(self, group: str, name: str) -> int:
        with self._lock:
            return self._groups[group].get(name, 0)

    def items(self) -> Iterator[Tuple[str, str, int]]:
        snap = self.as_dict()
        for g in sorted(snap):
            for n in sorted(snap[g]):
                yield g, n, snap[g][n]

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {g: dict(names) for g, names in self._groups.items()}

    def format(self) -> str:
        return "\n".join(f"{g}\t{n}\t{v}" for g, n, v in self.items())


class ConfusionMatrix:
    """Binary confusion counts; constructor order (negClass, posClass);
    percentages are floor-divided ints."""

    def __init__(self, neg_class: str, pos_class: str):
        self.neg_class = neg_class
        self.pos_class = pos_class
        self.true_pos = self.false_pos = self.true_neg = self.false_neg = 0

    def report(self, pred_class: str, actual_class: str) -> None:
        if pred_class == self.pos_class:
            if actual_class == self.pos_class:
                self.true_pos += 1
            else:
                self.false_pos += 1
        else:
            if actual_class == self.neg_class:
                self.true_neg += 1
            else:
                self.false_neg += 1

    def recall(self) -> int:
        return (100 * self.true_pos) // (self.true_pos + self.false_neg)

    def precision(self) -> int:
        return (100 * self.true_pos) // (self.true_pos + self.false_pos)

    def accuracy(self) -> int:
        total = self.true_pos + self.true_neg + self.false_pos + self.false_neg
        return (100 * (self.true_pos + self.true_neg)) // total

    def to_counters(self, counters: Counters, group: str = "Validation") -> None:
        counters.incr(group, "TruePositive", self.true_pos)
        counters.incr(group, "FalseNegative", self.false_neg)
        counters.incr(group, "TrueNagative", self.true_neg)  # sic, reference spelling
        counters.incr(group, "FalsePositive", self.false_pos)
        counters.incr(group, "Accuracy", self.accuracy())
        counters.incr(group, "Recall", self.recall())
        counters.incr(group, "Precision", self.precision())


class CostBasedArbitrator:
    """Pick the class minimizing expected misclassification cost
    (integer probabilities 0..100)."""

    def __init__(self, neg_class: str, pos_class: str,
                 false_neg_cost: int, false_pos_cost: int):
        self.neg_class = neg_class
        self.pos_class = pos_class
        self.false_neg_cost = false_neg_cost
        self.false_pos_cost = false_pos_cost

    def arbitrate(self, pos_prob: int, neg_prob: int) -> str:
        neg_cost = self.false_neg_cost * pos_prob + neg_prob
        pos_cost = self.false_pos_cost * neg_prob + pos_prob
        return self.pos_class if pos_cost < neg_cost else self.neg_class

    def classify(self, pos_prob: int) -> str:
        """The kNN voter's single-probability form: positive above the
        cost-weighted threshold (integer percent)."""
        threshold = ((self.false_pos_cost * 100)
                     // (self.false_pos_cost + self.false_neg_cost))
        return self.pos_class if pos_prob > threshold else self.neg_class

