"""E-learning rows, drawn from ``--seed``: a vectorised copy of the
distributions of avenir's ``gen_elearn`` (``resource/elearn.py``; the
port keeps it as ``avenir_tpu_torch.datagen.gen_elearn``).

Rows are ``id`` then the nine activity features of ``elearn.json``
(contentTime, discussTime, organizerTime, emailCount, testScore,
assignmentScore, chatMsgCount, searchTime, bookMarkCount) and the P/F
``status``.  Each feature is ``max(int(normal(mean, sd)), 0)``, the two
scores ``int(clip(normal(mean, sd), 10, 100))``; the status is F where a
draw of 0..100 falls below a fail probability that low scores and low
engagement raise.  The organizer term checks ``discuss``, as the
tutorial's generator does.

Identifiers are ``T<n>`` (training) and ``Q<n>`` (test), seven digits,
unique: the tutorial's random seven-digit ids collide at a million rows,
and the vote groups its pairs by the test id.  The arrays stay columnar
(``status`` 0 = P, 1 = F): the reference reads them, and the program
reads the text that ``csv_bytes`` makes of them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from harness.csvgen import int_table, join_rows

FIELDS = ("contentTime", "discussTime", "organizerTime", "emailCount",
          "testScore", "assignmentScore", "chatMsgCount", "searchTime",
          "bookMarkCount")
CLASSES = (b"P", b"F")
# (mean, sd) of each feature's normal draw
DRAW = {"contentTime": (300, 100), "discussTime": (80, 40),
        "organizerTime": (40, 20), "emailCount": (10, 6),
        "testScore": (50, 30), "assignmentScore": (60, 40),
        "chatMsgCount": (100, 60), "searchTime": (60, 40),
        "bookMarkCount": (12, 8)}
SCORES = ("testScore", "assignmentScore")
ID_DIGITS = 7


def _step(x, cuts):
    """The fail-probability term of a feature: the addend of the first
    ``(below, add)`` whose bound ``x`` lies under, else 0."""
    out = np.zeros(len(x), np.int64)
    for below, add in reversed(cuts):
        out = np.where(x < below, add, out)
    return out


def rows(n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """``n`` rows as columns."""
    cols = {}
    for name in FIELDS:
        v = rng.normal(*DRAW[name], n)
        if name in SCORES:
            cols[name] = np.trunc(np.clip(v, 10, 100)).astype(np.int64)
        else:
            cols[name] = np.maximum(np.trunc(v), 0).astype(np.int64)
    c = cols
    fail = (10 + _step(c["contentTime"], ((100, 10), (150, 6)))
            + _step(c["discussTime"], ((30, 8), (50, 4)))
            + _step(c["discussTime"], ((10, 5),))
            + _step(c["emailCount"], ((3, 6),))
            + _step(c["testScore"], ((30, 34), (40, 20), (50, 14)))
            + _step(c["assignmentScore"], ((35, 28), (50, 18), (60, 10)))
            + _step(c["chatMsgCount"], ((20, 4),))
            + _step(c["searchTime"], ((15, 7), (30, 3)))
            + _step(c["bookMarkCount"], ((4, 8),)))
    cols["status"] = (rng.integers(0, 101, n) < fail).astype(np.int64)
    return cols


def csv_bytes(cols: Dict[str, np.ndarray], id_prefix: bytes) -> bytes:
    n = len(cols["status"])
    spec = [("digits", id_prefix, np.arange(n), ID_DIGITS)]
    for name in FIELDS:
        spec.append(("table", int_table(int(cols[name].max(initial=0))),
                     cols[name]))
    spec.append(("table", CLASSES, cols["status"]))
    return join_rows(spec)


def make(seed: int, n_train: int, n_pool: int) -> dict:
    """The training rows and the test rows (``pool``) of one run, from two
    independent streams of ``seed``."""
    train = rows(n_train, np.random.default_rng([seed, 1]))
    pool = rows(n_pool, np.random.default_rng([seed, 2])) if n_pool else None
    return {"train": train, "pool": pool}
