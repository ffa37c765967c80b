"""Open-loop arrivals, from a cell's traffic parameters and ``--seed``.

``poisson_fixed``: exactly ``round(rate * seconds)`` arrivals, placed
uniformly at random over the window and sorted: a Poisson process
conditioned on its count.  Every seed then sends the same number of
requests (the seed changes when, and which rows, not how many), so runs
on different seeds measure the same work.  The gaps are exponential in
all but the conditioning, as the port's own seeded open-loop generator
(``avenir_tpu_torch/workload/generators.py::arrival_offsets``, mode
``poisson``) draws them.

Each request gets a row of the pool (a seeded permutation, so no row
repeats while the pool lasts) and a variant (a seeded draw over
``variants`` with ``variant_weights``).
"""

from __future__ import annotations

import math

import numpy as np


def arrivals(params: dict, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """Intended send times, seconds from the window's start, sorted."""
    mode = params.get("arrivals", "poisson_fixed")
    rate = float(params["rate"])
    if mode == "poisson_fixed":
        n = int(round(rate * seconds))
        return np.sort(rng.random(n) * seconds)
    raise ValueError(f"unknown arrival mode {mode!r}")


def schedule(params: dict, seconds: float, seed: int, pool_size: int):
    """``(offsets, pool rows, variants)`` of every request of a window."""
    rng = np.random.default_rng([seed, 3])
    offsets = arrivals(params, seconds, rng)
    n = len(offsets)
    reps = -(-n // pool_size) if n else 1
    rows = np.concatenate([rng.permutation(pool_size)
                           for _ in range(reps)])[:n]
    names = list(params.get("variants", ["default"]))
    w = np.asarray(params.get("variant_weights", [1.0] * len(names)),
                   np.float64)
    pick = rng.choice(len(names), size=n, p=w / w.sum())
    return offsets, rows, [names[i] for i in pick]


def pool_size(params: dict, max_seconds: float = 51.0) -> int:
    """Rows in the request pool: at least ``pool_rows``, and enough that
    no row repeats within the longest window at the cell's rate."""
    need = int(math.ceil(float(params["rate"]) * max_seconds))
    return max(int(params.get("pool_rows", 65536)), need)
