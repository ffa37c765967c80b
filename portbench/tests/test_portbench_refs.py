"""Each reference against a case counted by hand."""

import math

import numpy as np

from harness import common

NB = common.load_module(common.BENCH_DIR / "refs" / "churn_nb.py", "ref_nb")
MK = common.load_module(common.BENCH_DIR / "refs" / "churn_markov.py",
                        "ref_mk")

# four rows: (plan, minUsed, dataUsed, csCall, csEmail, network, churned)
ROWS = [(0, 250, 150, 3, 5, 4, 0), (1, 450, 50, 1, 1, 6, 0),
        (0, 50, 950, 9, 13, 2, 1), (0, 2100, 120, 8, 9, 3, 1)]


def _nb_cols(rows):
    names = ("plan", "minUsed", "dataUsed", "csCall", "csEmail", "network",
             "churned")
    return {n: np.asarray([r[k] for r in rows]) for k, n in enumerate(names)}


def test_nb_model_lines_by_hand():
    # per class: each bin's posterior, class-prior and feature-prior line;
    # network's Java-long mean and sd; the pooled Gaussian prior last
    def b(c, o, label, n):
        return [f"{c},{o},{label},{n}", f"{c},,,{n}", f",{o},{label},{n}"]
    want = (b("N", 1, "planA", 1) + b("N", 1, "planB", 1)
            + b("N", 2, 1, 1) + b("N", 2, 2, 1)
            + b("N", 3, 0, 1) + b("N", 3, 1, 1)
            + b("N", 4, 0, 1) + b("N", 4, 1, 1)
            + b("N", 5, 0, 1) + b("N", 5, 1, 1)
            + ["N,6,,5,1", "N,,,2"]
            + b("Y", 1, "planA", 2)
            + b("Y", 2, 0, 1) + b("Y", 2, 10, 1)
            + b("Y", 3, 1, 1) + b("Y", 3, 9, 1)
            + b("Y", 4, 4, 2)
            + b("Y", 5, 2, 1) + b("Y", 5, 3, 1)
            + ["Y,6,,2,2", "Y,,,2", ",6,,3,3"])
    assert NB.model_lines(_nb_cols(ROWS)) == want


def test_nb_plan_order_is_first_seen():
    rows = [(1,) + r[1:] for r in ROWS[:1]] + ROWS
    lines = NB.model_lines(_nb_cols(rows))
    assert lines[0] == "N,1,planB,2" and lines[3] == "N,1,planA,1"


def test_nb_score_by_hand():
    # row (planA, 250, 150, 3, 5, network 4) against the four rows: every
    # class count is 2 rows x 6 features; Y has no minUsed bin 1 row, so
    # its product is 0; for N,
    # (1/12)^5 / ((3/24)(1/24)(2/24)(1/24)(1/24)) * 0.5 * g(4; 5, 1) /
    # g(4; 3, 3) = 32/6 * 0.5 * 3 exp(-1/2 + 1/18) = 512.9...
    scorer = NB.Scorer(_nb_cols(ROWS))
    q = _nb_cols([ROWS[0]])
    probs = scorer.probs(q, np.asarray([0]))
    assert probs.tolist() == [[512, 0]]
    assert math.isclose(32 / 6 * 0.5 * 3 * math.exp(-0.5 + 1 / 18) * 100,
                        512.94, rel_tol=1e-4)
    line = NB.expected_outputs(scorer, q, np.asarray([0]), "Q")[0]
    assert line == "Q00000000,planA,250,150,3,5,4,N,N,512"


def test_nb_judge_counts_each_kind():
    scorer = NB.Scorer(_nb_cols(ROWS))
    q = _nb_cols(ROWS)
    idx = np.arange(4)
    good = NB.expected_outputs(scorer, q, idx, "Q")
    answers = [{"output": good[0]}, {"output": good[1][:-1] + "9"},
               None, {"error": "shed", "shed": True}]
    got = NB.judge_serve(answers, idx, ["f64", "f64", "f32", "f32"],
                         scorer, q, "Q")
    assert got == {"unanswered": 1, "errored": 1, "f64_mismatch": 1,
                   "f32_violations": 0}


def _mk_cols():
    # L: LL LH LL; C: HH HH HL HH
    st = np.zeros((2, 25), np.int64)
    st[0, :3] = [0, 1, 0]
    st[1, :4] = [3, 3, 2, 3]
    return {"label": np.asarray([0, 1]), "length": np.asarray([3, 4]),
            "states": st}


def test_markov_model_lines_by_hand():
    # a row with any zero gets +1 in every cell, then (c * 1000) // sum
    want = ["LL,LH,HL,HH", "classLabel:L",
            "200,400,200,200", "400,200,200,200",
            "250,250,250,250", "250,250,250,250",
            "classLabel:C",
            "250,250,250,250", "250,250,250,250",
            "200,200,200,400", "166,166,333,333"]
    assert MK.model_lines(_mk_cols()) == want


def test_markov_log_odds_by_hand():
    scorer = MK.Scorer(_mk_cols())
    q = {"label": np.asarray([0]), "length": np.asarray([3]),
         "states": np.asarray([[0, 1, 3] + [0] * 22])}
    lo = scorer.log_odds(q, np.asarray([0]))[0]
    # LL->LH: 400 / 250, LH->HH: 200 / 250
    assert lo == math.log(400 / 250) + math.log(200 / 250)
    line = MK.expected_outputs(scorer, q, [0], "Q")[0]
    assert line == f"Q0000000,L,L,{float(lo)!r}"


def test_markov_judge_gap():
    scorer = MK.Scorer(_mk_cols())
    q = _mk_cols()
    idx = np.arange(2)
    good = MK.expected_outputs(scorer, q, idx, "Q")
    pre, _, v = good[1].rpartition(",")
    off = f"{pre},{float(v) * (1 + 1e-3)!r}"
    got = MK.judge_serve([{"output": good[0]}, {"output": off}], idx,
                         ["f64", "f32"], scorer, q, "Q")
    assert got["f64_mismatch"] == 0
    assert 5e-4 < got["f32_max_gap"] < 2e-3
