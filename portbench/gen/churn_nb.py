"""Telecom-churn rows, drawn from ``--seed``: a vectorised copy of the
distributions of avenir's ``gen_telecom_churn`` (the tutorial's
generator; the port keeps it as ``avenir_tpu_torch.datagen``).

Rows are ``id,plan,minUsed,dataUsed,csCall,csEmail,network,churned``
(``teleComChurn.json``).  About a fifth of the customers churn, from one
of three planted causes (a bad plan with heavy usage, too many service
contacts, a small network); the others draw usage by plan.  Every value
is clipped to the schema's declared range, so the served model's domain
check never refuses a row.

The arrays stay columnar (``plan`` 0 = planA, 1 = planB; ``churned`` 0 =
N, 1 = Y): the reference reads them, and the program reads the text that
``csv_bytes`` makes of them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from harness.csvgen import int_table, join_rows

FIELDS = ("plan", "minUsed", "dataUsed", "csCall", "csEmail", "network")
PLANS = (b"planA", b"planB")
CLASSES = (b"N", b"Y")
# (mean, sd) pairs of the generator, index 0 and 1
MIN_USAGE = ((600, 50), (1200, 300))
DATA_USAGE = ((200, 50), (500, 150))
CS_CALL = ((4, 1), (8, 2))
CS_EMAIL = ((6, 2), (10, 3))
NETWORK = ((3, 1), (6, 2))
HI = {"minUsed": 2200, "dataUsed": 1000, "csCall": 14, "csEmail": 22,
      "network": 12}


def _draw(rng, dist, idx, hi, n):
    """``rint(normal(mean, sd))`` clipped to ``[0, hi]``, with each row's
    (mean, sd) picked from ``dist`` by ``idx``."""
    idx = np.broadcast_to(np.asarray(idx), (n,))
    mean = np.asarray([d[0] for d in dist], np.float64)[idx]
    sd = np.asarray([d[1] for d in dist], np.float64)[idx]
    return np.clip(np.rint(rng.normal(mean, sd)), 0, hi).astype(np.int64)


def rows(n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """``n`` rows as columns."""
    churn = rng.integers(1, 100, n) > 80
    case = rng.integers(1, 4, n)
    loyal_plan = (rng.random(n) >= 0.5).astype(np.int64)   # 0 planA
    c1, c2, c3 = churn & (case == 1), churn & (case == 2), churn & (case == 3)
    plan = np.where(churn, np.where(c1, 0, 1), loyal_plan)
    # usage: churners draw the heavy profile, loyal customers their plan's
    prof = np.where(churn, 1, loyal_plan)
    mu = _draw(rng, MIN_USAGE, prof, HI["minUsed"], n)
    du = _draw(rng, DATA_USAGE, prof, HI["dataUsed"], n)
    mu = np.where(c3, np.minimum(mu + 200, HI["minUsed"]), mu)
    du = np.where(c3, np.minimum(du + 100, HI["dataUsed"]), du)
    cc = _draw(rng, CS_CALL, np.where(c2, 1, 0), HI["csCall"], n)
    ce = _draw(rng, CS_EMAIL, np.where(c2, 1, 0), HI["csEmail"], n)
    cc = np.where(c2, np.maximum(cc, 6), np.where(churn, cc,
                                                  np.minimum(cc, 2)))
    ce = np.where(c2, np.maximum(ce, 8), np.where(churn, ce,
                                                  np.minimum(ce, 3)))
    nw = _draw(rng, NETWORK, np.where(churn, 0, 1), HI["network"], n)
    return {"plan": plan, "minUsed": mu, "dataUsed": du, "csCall": cc,
            "csEmail": ce, "network": nw,
            "churned": churn.astype(np.int64)}


def csv_bytes(cols: Dict[str, np.ndarray], id_prefix: bytes) -> bytes:
    n = len(cols["plan"])
    return join_rows([
        ("digits", id_prefix, np.arange(n), 8),
        ("table", PLANS, cols["plan"]),
        ("table", int_table(HI["minUsed"]), cols["minUsed"]),
        ("table", int_table(HI["dataUsed"]), cols["dataUsed"]),
        ("table", int_table(HI["csCall"]), cols["csCall"]),
        ("table", int_table(HI["csEmail"]), cols["csEmail"]),
        ("table", int_table(HI["network"]), cols["network"]),
        ("table", CLASSES, cols["churned"]),
    ])


def make(seed: int, n_train: int, n_pool: int) -> dict:
    """The training rows and the request pool of one run, from two
    independent streams of ``seed``."""
    train = rows(n_train, np.random.default_rng([seed, 1]))
    pool = rows(n_pool, np.random.default_rng([seed, 2])) if n_pool else None
    return {"train": train, "pool": pool}
