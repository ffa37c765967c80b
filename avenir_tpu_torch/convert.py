"""Carry the reference package's state across: numpy arrays -> port
tensors on a given device.

The reference returns its state as numpy (count tables, the Naive Bayes
predictor's lookup tables); these functions give the port the same
values, so both packages can compute on identical inputs.  Every result
is a copy: the port may update a count table in place.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def count_table_to_device(counts, device) -> torch.Tensor:
    """A ``[C, F, B]`` count table as a contiguous int32 tensor, e.g. to
    seed a ``ChunkFold`` carry."""
    a = np.asarray(counts)
    if a.ndim != 3:
        raise ValueError(f"count table must be [C, F, B], got shape {a.shape}")
    return torch.tensor(a.astype(np.int32), device=device)


def predictor_tables_to_device(tables: Sequence[np.ndarray], device
                               ) -> Tuple[torch.Tensor, ...]:
    """The six tables ``BayesianPredictor._build_tables`` returns
    (``post, prior, gauss_post, gauss_prior, class_prior, is_cont``): five
    float64 tensors and the bool ``is_cont`` mask."""
    post, prior, gauss_post, gauss_prior, class_prior, is_cont = tables
    f64 = tuple(torch.tensor(np.asarray(t, dtype=np.float64), device=device)
                for t in (post, prior, gauss_post, gauss_prior, class_prior))
    return f64 + (torch.tensor(np.asarray(is_cont, dtype=bool),
                               device=device),)
