"""PAC computational-learning-theory sample-size calculator: the port's
copy of ``avenir_tpu/core/pac.py``.

Port of the reference's resource/comp_learn.py: hypothesis-space sizes for
conjunction-of-terms (comp_learn.py:26-33), k-term-DNF (:35-50), and k-CNF
(:52-58) spaces over categorical feature cardinalities, and the PAC bound
``m >= (1/e) * ln(|H| / p)`` tabulated over error/confidence grids
(:11-23).  Pure host math — a calculator, not a job.
"""

from __future__ import annotations

import math
from itertools import combinations
from typing import List, Sequence, Tuple

DEFAULT_ERRORS = (0.01, 0.02, 0.03, 0.04, 0.05)
DEFAULT_THRESHOLDS = (0.01, 0.02, 0.03, 0.04, 0.05)


def _value_combinations(feature_card: Sequence[int], num_vars: int) -> int:
    """Sum of cardinality products over num_vars-subsets of the features
    (comp_learn.py:60-78 generalized: the reference hand-rolls 3- and
    4-variable loops; combinations() covers every size)."""
    if num_vars == len(feature_card):
        p = 1
        for f in feature_card:
            p *= f
        return p
    total = 0
    for idx in combinations(range(len(feature_card)), num_vars):
        p = 1
        for i in idx:
            p *= feature_card[i]
        total += p
    return total


def terms_hyp_space(feature_card: Sequence[int], class_card: int) -> int:
    """Conjunction of all feature variables: prod(card_i + 1) * classes."""
    n = 1
    for f in feature_card:
        n *= f + 1
    return n * class_card


def dnf_hyp_space(feature_card: Sequence[int], class_card: int,
                  c_size: int, d_size: int) -> int:
    """k-term DNF: C(num_conjunctions, d_size) * classes."""
    n_conj = _value_combinations(feature_card, c_size)
    n = 1
    for i in range(d_size):
        n *= n_conj - i
    f = math.factorial(d_size)
    return (n // f) * class_card


def cnf_hyp_space_ln(feature_card: Sequence[int], class_card: int,
                     d_size: int) -> float:
    """k-CNF: returns ln|H| (the space is too large to materialize)."""
    n_disj = _value_combinations(feature_card, d_size)
    return n_disj / math.log2(math.e) + math.log(class_card)


def sample_sizes(num_hyp: int,
                 errors: Sequence[float] = DEFAULT_ERRORS,
                 thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                 ) -> List[Tuple[float, float, int]]:
    """PAC bound m = ln(|H|/p) / e per (error, confidence) grid point."""
    return [(e, p, int(math.log(num_hyp / p) / e))
            for e in errors for p in thresholds]


def sample_sizes_ln(num_hyp_ln: float,
                    errors: Sequence[float] = DEFAULT_ERRORS,
                    thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                    ) -> List[Tuple[float, float, int]]:
    """Same bound with ln|H| supplied directly (k-CNF path)."""
    return [(e, p, int((num_hyp_ln + math.log(1 / p)) / e))
            for e in errors for p in thresholds]
