"""The plain reference of the customer-churn Markov-chain deployment, in
NumPy (and PyTorch on the CPU for the bfloat16 control), and the
comparisons that decide ``correct``.

From the generated columns (``gen/churn_markov.py``) it works out again
the trainer's model text (``MarkovStateTransitionModel``: per class
label, in first-seen order, the state-transition counts with whole-row
Laplace correction, scaled to ``(count * 1000) // rowSum``) and each
served response line (``MarkovModelClassifier`` in validation mode:
``id,actual,predicted,logOdds`` with the log-odds the left-to-right sum
of ``log(P_L[from, to] / P_C[from, to])`` in float64, glibc's ``log``,
and L predicted where it is above 0).  It imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

STATES = ("LL", "LH", "HL", "HH")
LABELS = ("L", "C")
SCALE = 1000
S = len(STATES)

#: The limits of the compared numbers.  Exact comparisons have the limit
#: 0.  The float32 variant's largest gap to the float64 log-odds, as a
#: share of max(1, |log-odds|), is held under F32_GAP_LIMIT, set from
#: the program's and the bfloat16 control's readings (PERF.md).
F32_GAP_LIMIT = 1e-3
LIMITS = {"model_lines_differing": 0, "unanswered": 0, "errored": 0,
          "f64_mismatch": 0,
          "f32_max_gap": F32_GAP_LIMIT}


def counts(cols: Dict[str, np.ndarray], dtype=np.int64):
    """``(labels in first-seen order, counts [n_labels, S, S])``."""
    label = np.asarray(cols["label"], np.int64)
    order = []
    for code in (int(label[0]), 1 - int(label[0])) if len(label) else ():
        if np.any(label == code):
            order.append(code)
    rank = np.zeros(2, np.int64)
    for r, code in enumerate(order):
        rank[code] = r
    st = np.asarray(cols["states"], np.int64)
    length = np.asarray(cols["length"], np.int64)
    valid = np.arange(st.shape[1] - 1)[None, :] < (length[:, None] - 1)
    cell = (rank[label][:, None] * S + st[:, :-1]) * S + st[:, 1:]
    flat = np.bincount(cell[valid], minlength=len(order) * S * S)
    return ([LABELS[c] for c in order],
            flat.astype(dtype).reshape(len(order), S, S))


def normalize(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.int64).copy()
    needs = (c == 0).any(axis=-1)
    c[needs] += 1
    return (c * SCALE) // c.sum(axis=-1, keepdims=True)


def model_lines(cols: Dict[str, np.ndarray], dtype=np.int64) -> List[str]:
    labels, cnt = counts(cols, dtype)
    lines = [",".join(STATES)]
    for k, lbl in enumerate(labels):
        lines.append(f"classLabel:{lbl}")
        for row in normalize(cnt[k]):
            lines.append(",".join(str(int(v)) for v in row))
    return lines


def control_model_lines(cols: Dict[str, np.ndarray]) -> List[str]:
    """The control of the training cell: the reference in the program's
    place with its counts held in int16, the integer width below the
    int32 the trainer's count tables state."""
    return model_lines(cols, np.int16)


class Scorer:
    """The served classifier's log-ratio table, from the reference's own
    model, and the log-odds of a sequence."""

    def __init__(self, train_cols: Dict[str, np.ndarray]):
        labels, cnt = counts(train_cols)
        tabs = {lbl: normalize(cnt[k]).astype(np.float64)
                for k, lbl in enumerate(labels)}
        self.t0, self.t1 = tabs["L"], tabs["C"]

    def log_odds(self, cols: Dict[str, np.ndarray], idx: np.ndarray,
                 dtype: str = "float64") -> np.ndarray:
        st = np.asarray(cols["states"], np.int64)[idx]
        length = np.asarray(cols["length"], np.int64)[idx]
        if dtype == "bfloat16":
            import torch
            lo = torch.log(torch.from_numpy(self.t0).to(torch.bfloat16)
                           / torch.from_numpy(self.t1).to(torch.bfloat16))
            acc = torch.zeros(len(idx), dtype=torch.bfloat16)
            for t in range(st.shape[1] - 1):
                g = lo[torch.from_numpy(st[:, t]), torch.from_numpy(st[:, t + 1])]
                acc = acc + torch.where(torch.from_numpy(t < length - 1), g,
                                        torch.zeros((), dtype=torch.bfloat16))
            return acc.double().numpy()
        if dtype == "float64":
            lo = np.asarray([[math.log(a / b) for a, b in zip(ra, rb)]
                             for ra, rb in zip(self.t0, self.t1)])
            dt = np.float64
        else:
            dt = np.float32
            lo = np.log(self.t0.astype(dt) / self.t1.astype(dt))
        acc = np.zeros(len(idx), dt)
        for t in range(st.shape[1] - 1):
            g = lo[st[:, t], st[:, t + 1]].astype(dt)
            acc = acc + np.where(t < length - 1, g, dt(0.0))
        return acc.astype(np.float64) if dtype == "float64" else acc


def row_prefix(cols, i: int, id_prefix: str) -> str:
    return f"{id_prefix}{i:07d},{LABELS[int(cols['label'][i])]}"


def _line(prefix: str, lo) -> str:
    return f"{prefix},{'L' if lo > 0.0 else 'C'},{float(lo)!r}"


def expected_outputs(scorer: Scorer, pool, idx, id_prefix: str,
                     dtype: str = "float64") -> List[str]:
    lo = scorer.log_odds(pool, np.asarray(idx), dtype)
    return [_line(row_prefix(pool, int(i), id_prefix), v)
            for i, v in zip(idx, lo)]


def judge_serve(answers: Sequence[Optional[dict]], idx: np.ndarray,
                variants: Sequence[str], scorer: Scorer, pool,
                id_prefix: str) -> dict:
    """The compared numbers of a serving run (see refs/churn_nb.py): the
    float64 variant's lines exactly, the float32 variant's log-odds by
    its largest gap, its class by the sign of its own log-odds."""
    idx = np.asarray(idx)
    lo64 = scorer.log_odds(pool, idx, "float64")
    unanswered = errored = f64_bad = 0
    f32_gap = 0.0
    for k, ans in enumerate(answers):
        if ans is None:
            unanswered += 1
            continue
        if "error" in ans:
            errored += 1
            continue
        prefix = row_prefix(pool, int(idx[k]), id_prefix)
        out = ans.get("output")
        if variants[k] == "f64":
            f64_bad += out != _line(prefix, lo64[k])
            continue
        gap = math.inf
        if isinstance(out, str) and out.startswith(prefix + ","):
            fields = out[len(prefix) + 1:].split(",")
            try:
                v = float(fields[1]) if len(fields) == 2 else math.nan
            except ValueError:
                v = math.nan
            if math.isfinite(v) and fields[0] == ("L" if v > 0.0 else "C"):
                gap = abs(v - lo64[k]) / max(1.0, abs(lo64[k]))
        f32_gap = max(f32_gap, gap)
    return {"unanswered": unanswered, "errored": errored,
            "f64_mismatch": f64_bad,
            "f32_max_gap": float(f32_gap)}
