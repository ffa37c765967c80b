"""Class-labelled churn state sequences, drawn from ``--seed``: a
vectorised copy of the distributions of avenir's ``churn_state_seqs``
(the customer-churn Markov-chain tutorial's generator; the port keeps it
as ``avenir_tpu_torch.datagen``).

Rows are ``id,label,s1,...,sL`` with the label L (loyal) or C (churner),
each with probability one half, and L from 15 to 25 states over LL, LH,
HL and HH.  The first state is uniform; after it, the loyal chain draws
each state uniformly and the churner chain is absorbed into HH (0.7)
from every state, as the tutorial's two transition matrices are.

The arrays stay numeric (``label`` 0 = L, 1 = C; ``states`` [n, 25]
codes, only the first ``length`` of each row in use).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from harness.csvgen import join_rows

STATES = (b"LL", b"LH", b"HL", b"HH")
LABELS = (b"L", b"C")
MIN_LEN, MAX_LEN = 15, 25
# each class's next-state distribution (the same from every state)
NEXT = {0: (0.25, 0.25, 0.25, 0.25), 1: (0.1, 0.1, 0.1, 0.7)}


def rows(n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    label = rng.integers(0, 2, n)
    length = rng.integers(MIN_LEN, MAX_LEN + 1, n)
    states = np.empty((n, MAX_LEN), np.int64)
    states[:, 0] = rng.integers(0, 4, n)
    u = rng.random((n, MAX_LEN - 1))
    cdf = np.stack([np.cumsum(NEXT[0]), np.cumsum(NEXT[1])])[label]
    cdf[:, -1] = 1.0
    states[:, 1:] = (u[:, :, None] >= cdf[:, None, :3]).sum(axis=2)
    return {"label": label, "length": length, "states": states}


def csv_bytes(cols: Dict[str, np.ndarray], id_prefix: bytes) -> bytes:
    n = len(cols["label"])
    columns = [("digits", id_prefix, np.arange(n), 7),
               ("table", LABELS, cols["label"])]
    present = [None, None]
    for t in range(MAX_LEN):
        columns.append(("table", STATES, cols["states"][:, t]))
        present.append(None if t < MIN_LEN else cols["length"] > t)
    return join_rows(columns, present)


def make(seed: int, n_train: int, n_pool: int) -> dict:
    train = rows(n_train, np.random.default_rng([seed, 1]))
    pool = rows(n_pool, np.random.default_rng([seed, 2])) if n_pool else None
    return {"train": train, "pool": pool}
