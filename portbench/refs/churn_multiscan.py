"""The plain reference of the shared-scan churn workflow
(``resource/multiscan``), in NumPy and Python floats, and the comparison
that decides ``correct``.

It works the four jobs' outputs out again from the generated columns
(``gen/churn_multiscan.py``) and imports nothing of the program.  The
semantics are avenir's, on ``teleComChurnBinned.json``: every feature
binned (``plan`` by its declared vocabulary planA, planB; the integers
by ``value // bucketWidth``), the class vocabulary declared (N, Y).

- ``nb``: ``BayesianDistribution``'s model text: per class, feature and
  bin with a non-zero count, the posterior, class-prior and
  feature-prior lines, in class, feature and bin order.
- ``mi``: ``MutualInformation``'s seven distributions, its four mutual
  information sections and the MIM ranking
  (``MutualInformation.java``, ``MutualInformationScore.java``): each
  probability a count over the row count (over the class count where
  class-conditional), each sum a float64 loop in bin, then class order,
  the class-conditional pair section normalised by the row count as the
  Java does (``MutualInformation.java:759-762``).
- ``corr``: ``CramerCorrelation``'s index of ``plan`` against
  ``churned`` (``ContingencyMatrix.cramerIndex``): the sum of
  ``n_ij^2 / (row_i col_j)`` less one, over the smaller side less one.
- ``stats``: chombo's ``NumericalAttrStats`` over ``minUsed`` and
  ``dataUsed``: sum, sum of squares, count, mean, variance and standard
  deviation, unconditioned (condition "0") and per class value in
  sorted order.  The sums are of integers below 2^53, so they are exact
  in float64 whatever their order.

``outputs(cols, "float32")`` is the control: the same arithmetic in
float32, a precision below the float64 the jobs state.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

JOBS = ("nb", "mi", "corr", "stats")
# (name, ordinal, bucket width or None for the categorical plan)
FEATURES = (("plan", 1, None), ("minUsed", 2, 200), ("dataUsed", 3, 100),
            ("csCall", 4, 2), ("csEmail", 5, 4), ("network", 6, 2))
PLANS = ("planA", "planB")
CLASSES = ("N", "Y")
CORR_NAMES = ("plan", "churned")
STATS_ATTRS = ((2, "minUsed"), (3, "dataUsed"))

#: The limits of the compared numbers, all exact: every output line
#: byte-equal to the reference's, and no job run outside the shared scan
#: (a job that left the scan means the cell did not measure the fusion).
LIMITS = {"output_lines_differing": 0, "standalone_reruns": 0}


def _arith(dtype: str):
    """(number, log) in ``dtype``: Python floats for float64, numpy
    float32 scalars for the control."""
    if dtype == "float64":
        return float, math.log
    if dtype == "float32":
        return np.float32, lambda x: np.log(np.float32(x))
    raise ValueError(f"no arithmetic in {dtype}")


class Tables:
    """The counts every job reads: per feature the bin codes and the
    class-by-bin table, per feature pair the bin-by-bin-by-class table."""

    def __init__(self, cols: Dict[str, np.ndarray]):
        self.y = np.asarray(cols["churned"], np.int64)
        self.n = len(self.y)
        self.class_counts = [int((self.y == c).sum()) for c in (0, 1)]
        self.codes, self.labels, self.fc = [], [], []
        for name, _, width in FEATURES:
            v = np.asarray(cols[name], np.int64)
            code = v if width is None else v // width
            nb = len(PLANS) if width is None else int(code.max(initial=0)) + 1
            self.codes.append(code)
            self.labels.append(list(PLANS) if width is None
                               else [str(b) for b in range(nb)])
            self.fc.append(np.bincount(self.y * nb + code,
                                       minlength=2 * nb).reshape(2, nb))
        self.pairs = [(i, j) for i in range(len(FEATURES))
                      for j in range(i + 1, len(FEATURES))]
        self.pc = []
        for i, j in self.pairs:
            ni, nj = len(self.labels[i]), len(self.labels[j])
            key = (self.codes[i] * nj + self.codes[j]) * 2 + self.y
            self.pc.append(np.bincount(key, minlength=ni * nj * 2)
                           .reshape(ni, nj, 2))


def nb_lines(t: Tables) -> List[str]:
    out = []
    for c, cv in enumerate(CLASSES):
        for (_, ordinal, _), labels, fc in zip(FEATURES, t.labels, t.fc):
            for b, label in enumerate(labels):
                cnt = int(fc[c, b])
                if cnt:
                    out += [f"{cv},{ordinal},{label},{cnt}", f"{cv},,,{cnt}",
                            f",{ordinal},{label},{cnt}"]
    return out


def mi_lines(t: Tables, dtype: str = "float64") -> List[str]:
    num, log = _arith(dtype)
    total = num(t.n)
    cc = [num(c) for c in t.class_counts]
    ords = [o for _, o, _ in FEATURES]
    L = t.labels
    feat = [fc.sum(axis=0) for fc in t.fc]
    pair = [pc.sum(axis=2) for pc in t.pc]
    out = ["distribution:class"]
    out += [f"{CLASSES[c]},{cc[c] / total}" for c in (0, 1)]
    out.append("distribution:feature")
    for j, f in enumerate(feat):
        out += [f"{ords[j]},{L[j][b]},{num(v) / total}"
                for b, v in enumerate(f) if v]
    out.append("distribution:featurePair")
    for (i, j), pr in zip(t.pairs, pair):
        for b1, b2 in zip(*np.nonzero(pr)):
            out.append(f"{ords[i]},{ords[j]},{L[i][b1]},{L[j][b2]},"
                       f"{num(pr[b1, b2]) / total}")
    out.append("distribution:featureClass")
    for j, fc in enumerate(t.fc):
        for b, c in zip(*np.nonzero(fc.T)):
            out.append(f"{ords[j]},{L[j][b]},{CLASSES[c]},"
                       f"{num(fc[c, b]) / total}")
    out.append("distribution:featurePairClass")
    for (i, j), pc in zip(t.pairs, t.pc):
        for b1, b2, c in zip(*np.nonzero(pc)):
            out.append(f"{ords[i]},{ords[j]},{L[i][b1]},{L[j][b2]},"
                       f"{CLASSES[c]},{num(pc[b1, b2, c]) / total}")
    out.append("distribution:featureClassConditional")
    for j, fc in enumerate(t.fc):
        for c, b in zip(*np.nonzero(fc)):
            out.append(f"{ords[j]},{CLASSES[c]},{L[j][b]},"
                       f"{num(fc[c, b]) / cc[c]}")
    out.append("distribution:featurePairClassConditional")
    for (i, j), pc in zip(t.pairs, t.pc):
        for c, b1, b2 in zip(*np.nonzero(pc.transpose(2, 0, 1))):
            out.append(f"{ords[i]},{ords[j]},{CLASSES[c]},{L[i][b1]},"
                       f"{L[j][b2]},{num(pc[b1, b2, c]) / cc[c]}")

    out.append("mutualInformation:feature")
    feature_mi = []
    for j, (f, fc) in enumerate(zip(feat, t.fc)):
        s = num(0.0)
        for b in np.nonzero(f)[0]:
            fp = num(f[b]) / total
            for c in (0, 1):
                if fc[c, b]:
                    jp = num(fc[c, b]) / total
                    s += jp * log(jp / (fp * cc[c] / total))
        out.append(f"{ords[j]},{s}")
        feature_mi.append((ords[j], s))
    out.append("mutualInformation:featurePair")
    for (i, j), pr in zip(t.pairs, pair):
        s = num(0.0)
        for b1, b2 in zip(*np.nonzero(pr)):
            p1, p2 = num(feat[i][b1]) / total, num(feat[j][b2]) / total
            jp = num(pr[b1, b2]) / total
            s += jp * log(jp / (p1 * p2))
        out.append(f"{ords[i]},{ords[j]},{s}")
    out.append("mutualInformation:featurePairClass")
    for (i, j), pr, pc in zip(t.pairs, pair, t.pc):
        s = num(0.0)
        for b1, b2, c in zip(*np.nonzero(pc)):
            jfp = num(pr[b1, b2]) / total
            jp = num(pc[b1, b2, c]) / total
            s += jp * log(jp / (jfp * cc[c] / total))
        out.append(f"{ords[i]},{ords[j]},{s}")
    out.append("mutualInformation:featurePairClassConditional")
    for (i, j), pc in zip(t.pairs, t.pc):
        total_s = num(0.0)
        for c in (0, 1):
            cp = cc[c] / total
            s = num(0.0)
            for b1, b2 in zip(*np.nonzero(pc[:, :, c])):
                p1 = num(t.fc[i][c, b1]) / total
                p2 = num(t.fc[j][c, b2]) / total
                jp = num(pc[b1, b2, c]) / total
                s += cp * (jp * log(jp / (p1 * p2)))
            total_s += s
        out.append(f"{ords[i]},{ords[j]},{total_s}")
    out.append("mutualInformationScoreAlgorithm: mutual.info.maximization")
    out += [f"{o},{s}" for o, s in sorted(feature_mi, key=lambda t: -t[1])]
    return out


def corr_lines(cols: Dict[str, np.ndarray], dtype: str = "float64"
               ) -> List[str]:
    dt = np.float64 if dtype == "float64" else np.float32
    key = np.asarray(cols["plan"], np.int64) * 2 + np.asarray(
        cols["churned"], np.int64)
    t = np.bincount(key, minlength=4).reshape(2, 2).astype(dt)
    row, col = t.sum(axis=1), t.sum(axis=0)
    row[row == 0] = 1
    col[col == 0] = 1
    pearson = (t * t / (row[:, None] * col[None, :])).sum() - dt(1.0)
    index = pearson / dt(min(t.shape) - 1)
    if dtype == "float64":
        index = float(index)
    return [f"{CORR_NAMES[0]},{CORR_NAMES[1]},{index}"]


def stats_lines(cols: Dict[str, np.ndarray], dtype: str = "float64"
                ) -> List[str]:
    num, _ = _arith(dtype)
    y = np.asarray(cols["churned"], np.int64)
    groups = [("0", np.ones(len(y), bool))] + [
        (CLASSES[c], y == c) for c in (0, 1) if (y == c).any()]
    out = []
    for ordinal, name in STATS_ATTRS:
        v = np.asarray(cols[name], np.int64)
        for cond, sel in groups:
            w = v[sel]
            if dtype == "float64":
                s, s2 = float(int(w.sum())), float(int((w * w).sum()))
            else:
                wf = w.astype(np.float32)
                s, s2 = wf.sum(), (wf * wf).sum()
            cnt = len(w)
            mean = s / cnt
            var = s2 / cnt - mean * mean
            std = math.sqrt(max(var, 0.0)) if dtype == "float64" else \
                np.sqrt(max(var, num(0.0)))
            body = ",".join(str(x) for x in (s, s2, num(cnt), mean, var, std))
            out.append(f"{ordinal},{cond},{body}")
    return out


def outputs(cols: Dict[str, np.ndarray], dtype: str = "float64"
            ) -> Dict[str, List[str]]:
    """Each job's output lines by its manifest id, in ``dtype``."""
    t = Tables(cols)
    return {"nb": nb_lines(t), "mi": mi_lines(t, dtype),
            "corr": corr_lines(cols, dtype),
            "stats": stats_lines(cols, dtype)}


def lines_differing(got: Dict[str, List[str]],
                    want: Dict[str, List[str]]) -> int:
    """Lines of the jobs' outputs not byte-equal to the reference's, a
    missing or extra line counted as one."""
    diff = 0
    for jid, w in want.items():
        g = got.get(jid, [])
        diff += sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
    return diff
