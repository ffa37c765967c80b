"""The generators: the same seed gives the same rows, every value lies in
its schema's range and cardinality, and the text parses back to the
columns."""

import numpy as np
import pytest

from harness import common

GEN = {c: common.load_module(common.BENCH_DIR / "gen" / f"{c}.py",
                             f"gen_{c}") for c in ("churn_nb", "churn_markov")}
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3]


@pytest.mark.parametrize("config", sorted(GEN))
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_rows(config, seed):
    a = GEN[config].make(seed, 3000, 500)
    b = GEN[config].make(seed, 3000, 500)
    for part in ("train", "pool"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k])
    c = GEN[config].make(seed + 1, 3000, 500)
    assert any(not np.array_equal(a["train"][k], c["train"][k])
               for k in a["train"])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_churn_nb_ranges(seed):
    g = GEN["churn_nb"]
    cols = g.make(seed, 20000, 0)["train"]
    assert set(np.unique(cols["plan"])) == {0, 1}
    assert set(np.unique(cols["churned"])) == {0, 1}
    for name, hi in g.HI.items():
        assert cols[name].min() >= 0 and cols[name].max() <= hi, name
    share = cols["churned"].mean()
    assert 0.17 < share < 0.21           # 19 of 99 draws churn
    loyal = cols["churned"] == 0
    assert cols["csCall"][loyal].max() <= 2
    assert cols["csEmail"][loyal].max() <= 3


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_churn_markov_ranges(seed):
    cols = GEN["churn_markov"].make(seed, 20000, 0)["train"]
    assert cols["length"].min() == 15 and cols["length"].max() == 25
    assert cols["states"].min() == 0 and cols["states"].max() == 3
    assert 0.48 < cols["label"].mean() < 0.52
    churner = cols["states"][cols["label"] == 1][:, 1:]
    assert 0.68 < (churner == 3).mean() < 0.72      # absorbed into HH


def test_churn_nb_text_parses_back():
    g = GEN["churn_nb"]
    cols = g.make(5, 2000, 0)["train"]
    lines = g.csv_bytes(cols, b"C").decode().splitlines()
    assert len(lines) == 2000
    for i in (0, 1, 999, 1999):
        f = lines[i].split(",")
        assert f[0] == f"C{i:08d}"
        assert f[1] == ("planA", "planB")[cols["plan"][i]]
        assert [int(v) for v in f[2:7]] == [int(cols[n][i]) for n in
                                            ("minUsed", "dataUsed", "csCall",
                                             "csEmail", "network")]
        assert f[7] == "NY"[cols["churned"][i]]


def test_churn_markov_text_parses_back():
    g = GEN["churn_markov"]
    cols = g.make(6, 2000, 0)["train"]
    lines = g.csv_bytes(cols, b"E").decode().splitlines()
    assert len(lines) == 2000
    for i in (0, 3, 1998):
        f = lines[i].split(",")
        assert f[0] == f"E{i:07d}" and f[1] == "LC"[cols["label"][i]]
        n = int(cols["length"][i])
        assert f[2:] == [("LL", "LH", "HL", "HH")[s]
                         for s in cols["states"][i, :n]]


def test_arrivals_fixed_count():
    from harness import traffic
    rng = np.random.default_rng(1)
    t = traffic.arrivals({"rate": 800}, 51.0, rng)
    assert len(t) == 40800 and t.min() >= 0 and t.max() < 51.0
    assert np.all(np.diff(t) >= 0)


def test_unknown_arrival_mode_is_refused():
    from harness import traffic
    with pytest.raises(ValueError, match="unknown arrival mode"):
        traffic.arrivals({"rate": 100, "arrivals": "flash"}, 30.0,
                         np.random.default_rng(1))


def test_schedule_rows_do_not_repeat_within_the_pool():
    from harness import traffic
    params = {"rate": 1000, "variants": ["f32", "f64"],
              "variant_weights": [0.5, 0.5]}
    offs, rows, variants = traffic.schedule(params, 10.0, 2 ** 31 + 5, 65536)
    assert len(set(rows.tolist())) == len(rows) == 10000
    assert 0.45 < variants.count("f64") / len(variants) < 0.55
    again = traffic.schedule(params, 10.0, 2 ** 31 + 5, 65536)
    assert np.array_equal(again[1], rows) and again[2] == variants
