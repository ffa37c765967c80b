"""The plain reference of the telecom-churn Naive Bayes deployment, in
NumPy (and PyTorch on the CPU for the bfloat16 control), and the
comparisons that decide ``correct``.

It works everything out again from the generated columns
(``gen/churn_nb.py``): the trainer's model text
(``BayesianDistribution``), the served model's tables and each served
response line (``BayesianPredictor``'s scoring, as the serving adapter
answers a row).  It imports nothing of the program.

The semantics are avenir's: posterior, class-prior and feature-prior
lines per (class, feature, bin) with a non-zero count, in the order of
the class vocabulary (declared: N, Y), the schema's features and the
bins (a categorical's in first-seen order); a Gaussian feature's mean
and standard deviation as Java longs; a score is
``(int)(featPost * classPrior / featPrior * 100)`` with the densities
multiplied left to right in float64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

# (name, ordinal, bucket width or None for a categorical, declared max);
# network is the Gaussian feature
BINNED = (("plan", 1, None, None), ("minUsed", 2, 200, 2200),
          ("dataUsed", 3, 100, 1000), ("csCall", 4, 2, 14),
          ("csEmail", 5, 4, 22))
GAUSS = (("network", 6),)
F = len(BINNED) + len(GAUSS)
PLANS = ("planA", "planB")
CLASSES = ("N", "Y")
SQRT_2PI = math.sqrt(2.0 * math.pi)

#: The limits of the compared numbers.  Exact comparisons have the limit
#: 0; the float32 variant's tolerance is the one the deployment's
#: bp.properties states (max(2, 0.1%) of the float64 probability).
LIMITS = {"model_lines_differing": 0, "unanswered": 0, "errored": 0,
          "f64_mismatch": 0,
          "f32_violations": 0}


def _jdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _jstd(vsq: int, cnt: int, mean: int) -> int:
    if cnt <= 1:
        return 0
    t = (vsq - cnt * mean * mean) / (cnt - 1)
    return int(math.sqrt(t)) if t > 0 else 0


def _plan_order(plan: np.ndarray, declared: bool) -> List[int]:
    """Plan codes in vocabulary order: declared (the serving schema) or
    first seen in the file (the batch schema; a plan that never occurs
    has no lines either way)."""
    if declared or not len(plan):
        return [0, 1]
    first = int(plan[0])
    return [first, 1 - first]


class Counts:
    """The trainer's tables: per class, feature and bin counts, and each
    Gaussian feature's count, sum and sum of squares per class."""

    def __init__(self, cols: Dict[str, np.ndarray],
                 declared_plans: bool = False,
                 count_dtype=np.int64):
        y = np.asarray(cols["churned"], np.int64)
        self.n = len(y)
        self.plan_order = _plan_order(np.asarray(cols["plan"]),
                                      declared_plans)
        self.bins: List[np.ndarray] = []       # [2, nb] per binned feature
        for name, _, width, hi in BINNED:
            v = np.asarray(cols[name], np.int64)
            if width is None:
                nb = len(PLANS)
                code = v
            else:
                nb = max(hi // width + 1, int(v.max()) // width + 1)
                code = v // width
            flat = np.bincount(y * nb + code, minlength=2 * nb)
            self.bins.append(flat.astype(count_dtype).reshape(2, nb))
        self.moments = []                      # (cnt, sum, sumsq) per class
        for name, _ in GAUSS:
            v = np.asarray(cols[name], np.int64)
            self.moments.append([
                (int((y == c).sum()), int(v[y == c].sum()),
                 int((v[y == c] ** 2).sum())) for c in (0, 1)])

    def model_lines(self) -> List[str]:
        lines = []
        prior_mom: Dict[int, List[int]] = {}
        for c, cv in enumerate(CLASSES):
            for (name, ordinal, width, _), tab in zip(BINNED, self.bins):
                order = (self.plan_order if width is None
                         else range(tab.shape[1]))
                for b in order:
                    cnt = int(tab[c, b])
                    if cnt == 0:
                        continue
                    label = PLANS[b] if width is None else str(b)
                    lines.append(f"{cv},{ordinal},{label},{cnt}")
                    lines.append(f"{cv},,,{cnt}")
                    lines.append(f",{ordinal},{label},{cnt}")
            for (name, ordinal), mom in zip(GAUSS, self.moments):
                cnt, vsum, vsq = mom[c]
                if cnt == 0:
                    continue
                mean = _jdiv(vsum, cnt)
                lines.append(f"{cv},{ordinal},,{mean},{_jstd(vsq, cnt, mean)}")
                lines.append(f"{cv},,,{cnt}")
                pm = prior_mom.setdefault(ordinal, [0, 0, 0])
                pm[0] += cnt
                pm[1] += vsum
                pm[2] += vsq
        for ordinal, (cnt, vsum, vsq) in sorted(prior_mom.items()):
            mean = _jdiv(vsum, cnt)
            lines.append(f",{ordinal},,{mean},{_jstd(vsq, cnt, mean)}")
        return lines


def model_lines(cols: Dict[str, np.ndarray]) -> List[str]:
    """The trainer's output for the batch schema (plan vocabulary in
    first-seen order)."""
    return Counts(cols).model_lines()


def control_model_lines(cols: Dict[str, np.ndarray]) -> List[str]:
    """The control of the training cell: the reference in the program's
    place with its counts held in int16, the integer width below the
    int32 the trainer's count tables state."""
    return Counts(cols, count_dtype=np.int16).model_lines()


class Scorer:
    """The served model's tables (from the reference's own counts) and
    the float64 score of a row; ``dtype`` float32 or bfloat16 gives the
    controls."""

    def __init__(self, train_cols: Dict[str, np.ndarray]):
        ct = Counts(train_cols, declared_plans=True)
        # every row adds one class-prior count per feature
        class_count = np.asarray([int(sum(int(t[c].sum()) for t in ct.bins)
                                      + sum(m[c][0] for m in ct.moments))
                                  for c in (0, 1)])
        total = int(class_count.sum())
        self.class_prior = np.asarray([int(c) / total for c in class_count])
        self.post = [np.asarray([[int(t[c, b]) / int(class_count[c])
                                  for b in range(t.shape[1])]
                                 for c in (0, 1)]) for t in ct.bins]
        self.prior = [np.asarray([int(t[:, b].sum()) / total
                                  for b in range(t.shape[1])])
                      for t in ct.bins]
        self.gauss_post, self.gauss_prior = [], []
        for mom in ct.moments:
            gp = []
            for c in (0, 1):
                cnt, vsum, vsq = mom[c]
                mean = _jdiv(vsum, cnt)
                gp.append((float(mean), float(_jstd(vsq, cnt, mean))))
            self.gauss_post.append(gp)
            cnt = sum(m[0] for m in mom)
            vsum = sum(m[1] for m in mom)
            vsq = sum(m[2] for m in mom)
            mean = _jdiv(vsum, cnt)
            self.gauss_prior.append((float(mean),
                                     float(_jstd(vsq, cnt, mean))))

    @staticmethod
    def _codes(cols, idx):
        out = []
        for name, _, width, _ in BINNED:
            v = np.asarray(cols[name], np.int64)[idx]
            out.append(v if width is None else v // width)
        return out

    def probs(self, cols: Dict[str, np.ndarray], idx: np.ndarray,
              dtype: str = "float64") -> np.ndarray:
        """int32 ``[n, 2]`` class probabilities of rows ``idx``."""
        if dtype == "bfloat16":
            return self._probs_torch(cols, idx)
        dt = np.float64 if dtype == "float64" else np.float32
        codes = self._codes(cols, idx)
        gvals = [np.asarray(cols[name], dt)[idx] for name, _ in GAUSS]

        def gauss(v, mean, std):
            std = dt(max(std, 1e-9))
            z = (v - dt(mean)) / std
            return np.exp(dt(-0.5) * z * z) / (std * dt(SQRT_2PI))

        with np.errstate(over="ignore", under="ignore", invalid="ignore",
                         divide="ignore"):
            fp = None
            for k, code in enumerate(codes):
                f = self.prior[k].astype(dt)[code]
                fp = f if fp is None else fp * f
            for k, v in enumerate(gvals):
                fp = fp * gauss(v, *self.gauss_prior[k])
            out = np.zeros((len(idx), 2), np.int32)
            for c in (0, 1):
                fc = None
                for k, code in enumerate(codes):
                    f = self.post[k][c].astype(dt)[code]
                    fc = f if fc is None else fc * f
                for k, v in enumerate(gvals):
                    fc = fc * gauss(v, *self.gauss_post[k][c])
                ratio = (fc * dt(self.class_prior[c])
                         / np.maximum(fp, dt(1e-300) if dt is np.float64
                                      else dt(np.finfo(np.float32).tiny)))
                out[:, c] = java_int32(ratio * dt(100))
        return out

    def _probs_torch(self, cols, idx) -> np.ndarray:
        """The bfloat16 control, with PyTorch on the CPU."""
        import torch
        bf = torch.bfloat16
        codes = [torch.from_numpy(c) for c in self._codes(cols, idx)]
        gvals = [torch.from_numpy(np.asarray(cols[name], np.float64)[idx]
                                  ).to(bf) for name, _ in GAUSS]

        def gauss(v, mean, std):
            std = max(std, 1e-9)
            z = (v - mean) / std
            return torch.exp(-0.5 * z * z) / (std * SQRT_2PI)

        fp = None
        for k, code in enumerate(codes):
            f = torch.from_numpy(self.prior[k]).to(bf)[code]
            fp = f if fp is None else fp * f
        for k, v in enumerate(gvals):
            fp = fp * gauss(v, *self.gauss_prior[k])
        out = np.zeros((len(idx), 2), np.int32)
        for c in (0, 1):
            fc = None
            for k, code in enumerate(codes):
                f = torch.from_numpy(self.post[k][c]).to(bf)[code]
                fc = f if fc is None else fc * f
            for k, v in enumerate(gvals):
                fc = fc * gauss(v, *self.gauss_post[k][c])
            ratio = fc * float(self.class_prior[c]) / fp.clamp_min(1e-30)
            out[:, c] = java_int32((ratio * 100).double().numpy())
        return out


def java_int32(x: np.ndarray) -> np.ndarray:
    """Java's ``(int)`` of a double: NaN to 0, saturating, truncating."""
    x = np.asarray(x, np.float64)
    x = np.where(np.isnan(x), 0.0, x)
    return np.clip(x, -2147483648.0, 2147483647.0).astype(np.int32)


def row_text(cols: Dict[str, np.ndarray], i: int, id_prefix: str) -> str:
    return ",".join([f"{id_prefix}{i:08d}", PLANS[int(cols["plan"][i])]]
                    + [str(int(cols[n][i])) for n in
                       ("minUsed", "dataUsed", "csCall", "csEmail",
                        "network")]
                    + [CLASSES[int(cols["churned"][i])]])


def _pick(probs: np.ndarray) -> np.ndarray:
    """The predicted class: the first of the largest probabilities."""
    return np.argsort(-probs, axis=1, kind="stable")[:, 0]


def expected_outputs(scorer: Scorer, pool: Dict[str, np.ndarray],
                     idx: np.ndarray, id_prefix: str,
                     dtype: str = "float64") -> List[str]:
    """The response line of each pool row in ``idx``, scored in
    ``dtype``."""
    probs = scorer.probs(pool, idx, dtype)
    pred = _pick(probs)
    return [f"{row_text(pool, int(i), id_prefix)},{CLASSES[p]},"
            f"{int(probs[k, p])}"
            for k, (i, p) in enumerate(zip(idx, pred))]


def _f32_ok(out: str, line: str, p64: np.ndarray) -> bool:
    """A float32 answer within the stated contract: the row's own text,
    then a class whose float64 probability is within tolerance of the
    best, and its probability within max(2, 0.1%) of that class's float64
    one (0.3% above 1e8)."""
    head, _, tail = out.rpartition(",")
    text, _, cls = head.rpartition(",")
    if text != line or cls not in CLASSES or not tail.lstrip("-").isdigit():
        return False

    def tol(p):
        p = abs(float(p))
        return max(2.0, p * 1e-3, (3e-3 * p) if p > 1e8 else 0.0)

    c = CLASSES.index(cls)
    best = float(p64.max())
    return (abs(int(tail) - float(p64[c])) <= tol(p64[c])
            and float(p64[c]) >= best - tol(best))


def judge_serve(answers: Sequence[Optional[dict]], idx: np.ndarray,
                variants: Sequence[str], scorer: Scorer,
                pool: Dict[str, np.ndarray], id_prefix: str,
                control: Optional[Dict[str, List[str]]] = None) -> dict:
    """The compared numbers of a serving run.  ``answers[k]`` is the
    parsed response to request ``k`` (None: never came); an error
    response (shed, timed out, unscored) counts under ``errored``: below
    the knee no request of a cell should fail.  ``control`` puts the
    given output lines (per variant) in the program's place."""
    idx = np.asarray(idx)
    p64 = scorer.probs(pool, idx, "float64")
    pred = _pick(p64)
    unanswered = errored = f64_bad = f32_bad = 0
    for k, ans in enumerate(answers):
        if ans is None:
            unanswered += 1
            continue
        if "error" in ans:
            errored += 1
            continue
        line = row_text(pool, int(idx[k]), id_prefix)
        out = ans.get("output")
        if not isinstance(out, str):
            f64_bad += variants[k] == "f64"
            f32_bad += variants[k] != "f64"
            continue
        if variants[k] == "f64":
            want = f"{line},{CLASSES[pred[k]]},{int(p64[k, pred[k]])}"
            f64_bad += out != want
        else:
            f32_bad += not _f32_ok(out, line, p64[k])
    return {"unanswered": unanswered, "errored": errored,
            "f64_mismatch": f64_bad,
            "f32_violations": f32_bad}
