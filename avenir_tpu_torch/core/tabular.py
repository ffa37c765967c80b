"""Labeled count matrices with the reference's normalization and
serialization: the port's copy of ``avenir_tpu/core/tabular.py``.

Equivalent of avenir's ``StateTransitionProbability`` (extends chombo
``TabularData``; util/StateTransitionProbability.java:28-129): integer count
matrix, row normalization with whole-row Laplace correction, int-scaled or
double output, one comma-joined row per line.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DELIM = ","


def laplace_correct_rows(counts: np.ndarray) -> np.ndarray:
    """If ANY cell in a row is zero, add 1 to EVERY cell of that row
    (util/StateTransitionProbability.java:66-78 — whole-row correction, not
    per-cell)."""
    counts = np.asarray(counts, dtype=np.int64).copy()
    needs = (counts == 0).any(axis=-1)
    counts[needs] += 1
    return counts


def normalize_rows(counts: np.ndarray, scale: int) -> np.ndarray:
    """Row-normalize with Laplace correction.  ``scale > 1``: integer
    ``(count * scale) // rowSum`` (Java int division,
    StateTransitionProbability.java:89); ``scale == 1``: float division."""
    c = laplace_correct_rows(counts)
    row_sum = c.sum(axis=-1, keepdims=True)
    if scale > 1:
        return (c * scale) // row_sum
    return c / row_sum


def serialize_matrix(mat: np.ndarray) -> List[str]:
    """One comma-joined line per row; ints stay ints, doubles print as Java
    Double.toString-compatible reprs."""
    lines = []
    for row in np.atleast_2d(mat):
        if np.issubdtype(row.dtype, np.integer):
            lines.append(DELIM.join(str(int(v)) for v in row))
        else:
            lines.append(DELIM.join(repr(float(v)) for v in row))
    return lines


def deserialize_matrix(lines: Sequence[str], num_rows: int) -> np.ndarray:
    """Parse ``num_rows`` comma-joined numeric lines into a float matrix
    (the reference loads scaled-int model files into DoubleTable,
    markov/MarkovModel.java:51-62 — everything becomes double)."""
    return np.asarray([[float(v) for v in lines[i].split(DELIM)]
                       for i in range(num_rows)])
