"""The plain reference of the e-learning kNN deployment, in plain
PyTorch, and the comparisons that decide ``correct``.

It works everything out again from the generated columns
(``gen/knn_elearn.py``) and imports nothing of the program:

- the distance job (sifarish ``SameTypeSimilarity`` as ``resource/knn.sh``
  runs it): each numeric feature range-normalised by the schema's
  declared min and max, the euclidean distance weight-averaged over the
  features (every weight 1) and scaled by ``distance.scale``, truncated
  to an int; computed in float64, one feature at a time into a block of
  test rows x all training rows, as differences (no matmul expansion,
  which cancels), and the k nearest training rows of each test row by
  (int distance, training index) ascending;
- the vote (``NearestNeighbor`` with ``kernel.function=none``): each
  test row's pairs sorted by distance (arrival order among equal ones),
  the first ``top.match.count`` each a vote of 1, the class with most
  votes (the first to appear among them on a tie), and in validation mode
  the confusion counts as avenir's integer percentages.

The program computes its distances in float32 (K3 expands the square),
so its int distance of a pair may differ by one unit from the float64
one where the value lies on a rounding boundary (the port's contract,
``ops/distance.py``): the pair lines are held to that contract
(``pairs_outside_contract``), and byte equality is only asked of 99% of
the test rows (``rows_differing_share``).  The vote is exact integer
arithmetic, so it is held to the reference's vote over the program's own
pair lines with no difference at all (``predictions_differing``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the features of elearn.json in column order: (name, declared min,
#: declared max); every weight is 1
FEATURES = (("contentTime", 0, 700), ("discussTime", 0, 300),
            ("organizerTime", 0, 150), ("emailCount", 0, 40),
            ("testScore", 10, 100), ("assignmentScore", 10, 100),
            ("chatMsgCount", 0, 400), ("searchTime", 0, 250),
            ("bookMarkCount", 0, 50))
CLASSES = ("P", "F")
#: ConfusionMatrix(cardinality[0], cardinality[1]): (negative, positive)
NEG, POS = CLASSES
ID_DIGITS = 7
#: pairs (test rows x training rows) of one block of the float64 pass
BLOCK_PAIRS = 1 << 27

#: The limits of the compared numbers.
#: - ``pairs_outside_contract``: 0.  Every test row has exactly k lines
#:   with its own id and class and the training row's; each line's int
#:   distance lies within 1 unit of the float64 int distance of that
#:   same pair; the row's distances, sorted, lie within 1 unit of the
#:   reference's k smallest, position by position.  The unit is the
#:   engines' stated difference (``ops/distance.py``); anything beyond it
#:   is a wrong neighbour or a wrong distance.
#: - ``rows_differing_share``: 0.01, the share of test rows whose lines
#:   are not byte-equal to the reference's (``chip_smoke.py``'s
#:   ``compare_pairs`` bound): rows differ only where a distance lies on
#:   a rounding boundary, so that the float32 value truncates to the
#:   other int, which moves the row's order among equal distances.
#: - ``predictions_differing``: 0.  The prediction lines and the
#:   validation counters against the reference's vote over the program's
#:   own pair lines: exact integer arithmetic.
LIMITS = {"pairs_outside_contract": 0, "rows_differing_share": 0.01,
          "predictions_differing": 0}


def normalized(cols: Dict[str, np.ndarray]) -> np.ndarray:
    """The feature columns range-normalised, float64 ``[n, F]``."""
    return np.stack([(cols[name].astype(np.float64) - lo) / (hi - lo)
                     for name, lo, hi in FEATURES], axis=1)


def int_distances(q: torch.Tensor, t: torch.Tensor, scale: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Int distances ``[nq, nt]`` (int64) of normalised rows ``q`` and
    ``t``: the squared differences summed one feature at a time, left to
    right, over the weight sum, the square root, times ``scale``,
    truncated; every step in ``dtype``, in place on one block."""
    def const(v):
        return torch.tensor(float(v), dtype=dtype, device=q.device)
    q, t = q.to(dtype), t.to(dtype)
    acc = torch.sub(q[:, :1], t[None, :, 0]).square_()
    diff = torch.empty_like(acc)
    for f in range(1, q.shape[1]):
        torch.sub(q[:, f:f + 1], t[None, :, f], out=diff)
        acc.addcmul_(diff, diff)
    del diff
    acc.div_(const(q.shape[1])).sqrt_().mul_(const(scale)).trunc_()
    return acc.to(torch.int64)


def nearest(train: Dict[str, np.ndarray], test: Dict[str, np.ndarray],
            k: int, scale: int, device=None, dtype=torch.float64
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The k nearest training rows of each test row, by (int distance,
    training index) ascending: ``(dist [nq, k], idx [nq, k])`` int64,
    computed on ``device`` in blocks of test rows, every step of the
    distance in ``dtype``."""
    device = torch.device(device or "cpu")
    t = torch.from_numpy(normalized(train)).to(device)
    q = torch.from_numpy(normalized(test)).to(device)
    nt = t.shape[0]
    ar = torch.arange(nt, dtype=torch.int64, device=device)
    step = max(BLOCK_PAIRS // max(nt, 1), 1)
    dist, idx = [], []
    for lo in range(0, q.shape[0], step):
        keys = int_distances(q[lo:lo + step], t, scale, dtype)
        keys.bitwise_left_shift_(32).bitwise_or_(ar)
        kv = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        del keys
        dist.append((kv >> 32).cpu().numpy())
        idx.append((kv & 0xFFFFFFFF).cpu().numpy())
    return np.concatenate(dist), np.concatenate(idx)


def pair_distances(train: Dict[str, np.ndarray], test: Dict[str, np.ndarray],
                   qi: np.ndarray, ti: np.ndarray, scale: int
                   ) -> np.ndarray:
    """The float64 int distance of each pair ``(qi[j], ti[j])``."""
    t = torch.from_numpy(normalized(train)[ti])
    q = torch.from_numpy(normalized(test)[qi])
    acc = torch.zeros(len(qi), dtype=torch.float64)
    for f in range(q.shape[1]):
        diff = q[:, f] - t[:, f]
        acc.addcmul_(diff, diff)
    d = torch.sqrt(acc / float(q.shape[1]))
    return torch.trunc(d * float(scale)).to(torch.int64).numpy()


def _id(prefix: str, n: int) -> str:
    return f"{prefix}{n:0{ID_DIGITS}d}"


def _index(text: str, prefix: str, limit: int) -> Optional[int]:
    """The row of an id ``<prefix><7 digits>``, or None."""
    if len(text) != len(prefix) + ID_DIGITS or not text.startswith(prefix) \
            or not text[len(prefix):].isdigit():
        return None
    n = int(text[len(prefix):])
    return n if n < limit else None


def expected_pair_lines(train, test, dist: np.ndarray, idx: np.ndarray
                        ) -> List[List[str]]:
    """The reference's pair lines of each test row."""
    ty, qy = train["status"], test["status"]
    return [[f"{_id('T', t)},{_id('Q', q)},{d},{CLASSES[ty[t]]},"
             f"{CLASSES[qy[q]]}" for d, t in zip(dist[q], idx[q])]
            for q in range(len(dist))]


def check_pairs(lines: List[str], train, test, dist: np.ndarray,
                idx: np.ndarray, scale: int) -> Dict[str, float]:
    """``pairs_outside_contract`` and ``rows_differing_share`` of the
    program's pair lines against the reference's ``(dist, idx)``."""
    nq, k = dist.shape
    nt = len(train["status"])
    ty, qy = train["status"], test["status"]
    rows: List[List[str]] = [[] for _ in range(nq)]
    parsed: List[List[Tuple[int, int]]] = [[] for _ in range(nq)]
    bad = 0
    for line in lines:
        f = line.split(",")
        q = _index(f[1], "Q", nq) if len(f) == 5 else None
        if q is None:
            bad += 1                    # no test row to hold it to
            continue
        rows[q].append(line)
        t = _index(f[0], "T", nt)
        if (t is None or not f[2].isdigit() or f[3] != CLASSES[ty[t]]
                or f[4] != CLASSES[qy[q]]):
            bad += 1
            continue
        parsed[q].append((t, int(f[2])))
    want = expected_pair_lines(train, test, dist, idx)
    differ = sum(rows[q] != want[q] for q in range(nq))
    qs = np.asarray([q for q in range(nq) for _ in parsed[q]], np.int64)
    ts = np.asarray([t for q in range(nq) for t, _ in parsed[q]], np.int64)
    got = np.asarray([d for q in range(nq) for _, d in parsed[q]], np.int64)
    own = pair_distances(train, test, qs, ts, scale) if len(qs) else got
    bad += int((np.abs(got - own) > 1).sum())
    for q in range(nq):
        n = len(rows[q])
        bad += abs(n - k)
        ds = sorted(d for _, d in parsed[q])
        if len({t for t, _ in parsed[q]}) != len(parsed[q]):
            bad += len(parsed[q]) - len({t for t, _ in parsed[q]})
        if n == k and len(ds) == k:
            bad += int((np.abs(np.asarray(ds) - dist[q]) > 1).sum())
    return {"pairs_outside_contract": bad,
            "rows_differing_share": differ / max(nq, 1)}


def vote(lines: List[str], top: int) -> Tuple[List[str], Dict[str, int]]:
    """The reference's vote over pair lines ``trainId,testId,distance,
    trainClass,testClass``: the prediction lines ``testId,testClass,
    predicted`` in the order the test ids first appear, and the
    validation counters."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    actual: Dict[str, str] = {}
    for line in lines:
        f = line.split(",")
        groups.setdefault(f[1], []).append((int(f[2]), f[3]))
        actual[f[1]] = f[4]
    out = []
    tp = fp = tn = fn = 0
    for q, nbrs in groups.items():
        votes: Dict[str, int] = {}
        for _, c in sorted(nbrs, key=lambda n: n[0])[:top]:
            votes[c] = votes.get(c, 0) + 1
        best, most = "", 0
        for c, v in votes.items():
            if v > most:
                best, most = c, v
        out.append(f"{q},{actual[q]},{best}")
        if best == POS:
            tp, fp = (tp + 1, fp) if actual[q] == POS else (tp, fp + 1)
        else:
            tn, fn = (tn + 1, fn) if actual[q] == NEG else (tn, fn + 1)
    total = tp + tn + fp + fn
    counters = {"TruePositive": tp, "FalseNegative": fn, "TrueNagative": tn,
                "FalsePositive": fp,
                "Accuracy": (100 * (tp + tn)) // total if total else 0,
                "Recall": (100 * tp) // (tp + fn) if tp + fn else 0,
                "Precision": (100 * tp) // (tp + fp) if tp + fp else 0}
    return out, counters


def check_predictions(pair_lines: List[str], pred_lines: List[str],
                      counters: Dict[str, int], top: int) -> int:
    """Prediction lines that differ from the reference's vote over
    ``pair_lines`` (and lines missing or extra), plus one for each
    validation counter that differs."""
    want, want_counters = vote(pair_lines, top)
    diff = sum(a != b for a, b in zip(pred_lines, want))
    diff += abs(len(pred_lines) - len(want))
    diff += sum(counters.get(n) != v for n, v in want_counters.items())
    return diff


def control_pair_lines(train, test, k: int, scale: int, device=None
                       ) -> List[str]:
    """The reference in the program's place, computed in bfloat16: its
    pair lines, to be judged as a run's are."""
    dist, idx = nearest(train, test, k, scale, device, torch.bfloat16)
    return [line for row in expected_pair_lines(train, test, dist, idx)
            for line in row]
