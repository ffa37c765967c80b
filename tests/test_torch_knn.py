"""The port's kNN jobs (distance job, probability joiner, voting) and
greedy clustering held against the JAX package on the CPU.

Every output file must be byte-identical: the jobs of tests/test_knn.py
one by one, and the whole resource/knn_classify/run.sh sequence through
``avenir_tpu_torch.cli.main(... --device cpu)`` against
``avenir_tpu.cli.main``.  At the runbooks' ``distance.scale`` the
distances of these inputs stay clear of the int-scale rounding boundary;
at a larger scale one pair line shows the reference's one-unit contract.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest

from avenir_tpu import cli as jax_cli
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.datagen.cli import _blobs
from avenir_tpu.models import cluster as jcl
from avenir_tpu.models import knn as jknn

from avenir_tpu_torch import cli, datagen
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import write_output
from avenir_tpu_torch.models import cluster as tcl
from avenir_tpu_torch.models import knn as tknn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNBOOK = os.path.join(REPO, "resource", "knn_classify")

KNN_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "x1", "ordinal": 1, "dataType": "int", "feature": True,
     "min": 0, "max": 100},
    {"name": "x2", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "weight": 2.5},
    {"name": "grp", "ordinal": 3, "dataType": "categorical",
     "feature": True, "cardinality": ["a", "b"]},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _points(n, seed=0):
    """tests/test_knn.py's two blobs: Y near (80, 80, 'a'), N near
    (20, 20, 'b')."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        cx, g, lbl = (80, "a", "Y") if i % 2 else (20, "b", "N")
        x1 = int(np.clip(rng.normal(cx, 8), 0, 100))
        x2 = int(np.clip(rng.normal(cx, 8), 0, 100))
        rows.append([f"E{i}", str(x1), str(x2), g, lbl])
    return rows


@pytest.fixture
def knn_input(tmp_path):
    sp = tmp_path / "schema.json"
    sp.write_text(json.dumps(KNN_SCHEMA))
    os.makedirs(tmp_path / "inp")
    (tmp_path / "inp" / "tr.txt").write_text(
        "\n".join(",".join(r) for r in _points(40, seed=7)) + "\n")
    (tmp_path / "inp" / "te.txt").write_text(
        "\n".join(",".join(r) for r in _points(10, seed=8)) + "\n")
    return str(sp)


def _pair(tmp_path, jax_job, port_job, in_path, name):
    jout, pout = str(tmp_path / f"{name}_jax"), str(tmp_path / f"{name}_port")
    jc = jax_job.run(in_path, jout)
    pc = port_job.run(in_path, pout)
    assert _read(pout) == _read(jout)
    return jc, pc, jout, pout


@pytest.mark.parametrize("props", [
    pytest.param({}, id="all-pairs"),
    pytest.param({"output.top.matches": "5"}, id="top-k"),
    pytest.param({"output.top.matches": "4", "inter.set.matching": "false"},
                 id="self-join"),
    pytest.param({"output.top.matches": "6", "distance.algorithm":
                  "manhattan", "topk.method": "sorted"}, id="manhattan"),
    pytest.param({"include.class.attributes": "false"}, id="no-class"),
])
def test_same_type_similarity_matches_reference(tmp_path, knn_input, props):
    cfg = dict(props, **{"feature.schema.file.path": knn_input})
    jc, pc, _, _ = _pair(tmp_path, jknn.SameTypeSimilarity(JaxConfig(cfg)),
                         tknn.SameTypeSimilarity(JobConfig(dict(cfg)),
                                                 device="cpu"),
                         str(tmp_path / "inp"), "simi")
    assert pc.as_dict()["Basic"] == jc.as_dict()["Basic"]
    assert pc.get("Distance", "Re-resolved rows") == 0


def test_rounding_boundary_pairs_are_oracle_confirmed(tmp_path, knn_input):
    """At ``distance.scale=100000`` the float32 rounding of a distance
    of these inputs reaches the int-scale boundary: the two packages may
    print it one unit apart, and the float64 oracle's int distance must be
    within one unit of both (the reference's contract, as bench.py:1136-1156
    applies it)."""
    cfg = {"feature.schema.file.path": knn_input, "distance.scale": "100000"}
    jknn.SameTypeSimilarity(JaxConfig(cfg)).run(str(tmp_path / "inp"),
                                                str(tmp_path / "jax"))
    tknn.SameTypeSimilarity(JobConfig(dict(cfg)), device="cpu").run(
        str(tmp_path / "inp"), str(tmp_path / "port"))
    jl = _read(tmp_path / "jax").decode().splitlines()
    pl = _read(tmp_path / "port").decode().splitlines()
    rows = {r[0]: r for r in _points(40, seed=7) + _points(10, seed=8)}
    assert len(jl) == len(pl) == 400
    differ = 0
    for a, b in zip(jl, pl):
        if a == b:
            continue
        differ += 1
        fa, fb = a.split(","), b.split(",")
        assert fa[:2] + fa[3:] == fb[:2] + fb[3:]
        assert abs(int(fa[2]) - int(fb[2])) == 1
        want = int(_oracle_distance(rows[fa[0]], rows[fa[1]]) * 100000)
        assert max(abs(int(fa[2]) - want), abs(int(fb[2]) - want)) <= 1
    assert 0 < differ <= 4


def _oracle_distance(r, s):
    """Float64 distance of two KNN_SCHEMA rows (x2 weighs 2.5)."""
    w = np.asarray([1.0, 2.5, 1.0])
    d = np.asarray([(int(r[1]) - int(s[1])) / 100.0,
                    (int(r[2]) - int(s[2])) / 100.0])
    return math.sqrt((w[0] * d[0] ** 2 + w[1] * d[1] ** 2
                      + w[2] * (r[3] != s[3])) / w.sum())


@pytest.mark.parametrize("props", [
    pytest.param({"kernel.function": "none"}, id="none"),
    pytest.param({"kernel.function": "linearMultiplicative",
                  "output.class.distr": "true"}, id="linear-mult-distr"),
    pytest.param({"kernel.function": "linearAdditive"}, id="linear-add"),
    pytest.param({"kernel.function": "gaussian", "kernel.param": "50"},
                 id="gaussian"),
    pytest.param({"decision.threshold": "1.5",
                  "class.attribute.values": "Y,N"}, id="threshold"),
    pytest.param({"use.cost.based.classifier": "true",
                  "class.attribute.values": "Y,N",
                  "misclassification.cost": "3,1"}, id="cost-based"),
])
def test_nearest_neighbor_matches_reference(tmp_path, knn_input, props):
    cfg = {"feature.schema.file.path": knn_input}
    jknn.SameTypeSimilarity(JaxConfig(cfg)).run(str(tmp_path / "inp"),
                                                str(tmp_path / "simi"))
    vcfg = dict(props, **{"feature.schema.file.path": knn_input,
                          "top.match.count": "5", "validation.mode": "true"})
    jc, pc, _, _ = _pair(tmp_path, jknn.NearestNeighbor(JaxConfig(vcfg)),
                         tknn.NearestNeighbor(JobConfig(dict(vcfg)),
                                              device="cpu"),
                         str(tmp_path / "simi"), "pred")
    assert pc.as_dict() == jc.as_dict()


@pytest.mark.parametrize("method", ["average", "median", "linearRegression"])
def test_nearest_neighbor_regression_matches_reference(tmp_path, method):
    rng = np.random.default_rng(4)
    # trainId, testId, distance, target, testTarget, regrIn, testRegrIn
    lines = [f"T{i},Q{q},{int(rng.integers(0, 90))},{int(rng.integers(0, 500))},"
             f"{int(rng.integers(0, 9))},{rng.uniform(0, 10):.3f},"
             f"{rng.uniform(0, 10):.3f}"
             for q in range(6) for i in range(9)]
    write_output(str(tmp_path / "in"), lines)
    cfg = {"prediction.mode": "regression", "regression.method": method,
           "top.match.count": "4", "validation.mode": "true"}
    _pair(tmp_path, jknn.NearestNeighbor(JaxConfig(cfg)),
          tknn.NearestNeighbor(JobConfig(dict(cfg)), device="cpu"),
          str(tmp_path / "in"), "regr")


def test_joiner_and_weighted_vote_match_reference(tmp_path, knn_input):
    """tests/test_knn.py's class-conditional pipeline: distance + NB
    prob-only lines -> joiner -> weighted vote."""
    jknn.SameTypeSimilarity(JaxConfig(
        {"feature.schema.file.path": knn_input})).run(
        str(tmp_path / "inp"), str(tmp_path / "simi"))
    prob = []
    for r in _points(40, seed=7):
        p_y = 0.9 if r[4] == "Y" else 0.2
        prob.append(f"{r[0]},0.01,N,{1 - p_y},Y,{p_y},{r[4]}")
    os.makedirs(tmp_path / "pprob")
    (tmp_path / "pprob" / "prDistr-r-00000").write_text("\n".join(prob) + "\n")
    jcfg = {"feature.cond.prob.split.prefix": "prDistr"}
    _pair(tmp_path, jknn.FeatureCondProbJoiner(JaxConfig(jcfg)),
          tknn.FeatureCondProbJoiner(JobConfig(dict(jcfg)), device="cpu"),
          f"{tmp_path}/simi,{tmp_path}/pprob", "join")
    vcfg = {"feature.schema.file.path": knn_input, "top.match.count": "5",
            "validation.mode": "true", "class.condtion.weighted": "true",
            "inverse.distance.weighted": "true"}
    jc, pc, _, _ = _pair(tmp_path, jknn.NearestNeighbor(JaxConfig(vcfg)),
                         tknn.NearestNeighbor(JobConfig(dict(vcfg)),
                                              device="cpu"),
                         str(tmp_path / "join_jax"), "predw")
    assert pc.as_dict() == jc.as_dict()


def test_neighborhood_kernels_match_reference():
    d = np.asarray([0, 1, 3, 50, 99, 100, 200, 1234])
    for kf, param in (("none", -1), ("linearMultiplicative", -1),
                      ("linearAdditive", -1), ("gaussian", 50)):
        np.testing.assert_array_equal(
            tknn.Neighborhood(kf, param).scores(d),
            jknn.Neighborhood(kf, param).scores(d))
    posts = np.asarray([0.5, -1.0, 0.0, 0.25, 1.0, 0.1, 0.3, 0.9])
    for idw in (False, True):
        a = tknn.Neighborhood("none", inverse_distance_weighted=idw)
        b = jknn.Neighborhood("none", inverse_distance_weighted=idw)
        np.testing.assert_array_equal(
            a.weighted_scores(a.scores(d), d, posts),
            b.weighted_scores(b.scores(d), d, posts))
    with pytest.raises(ValueError):
        tknn.Neighborhood("sigmoid").scores(d)
    assert tknn.Neighborhood("gaussian", 50).scores(
        np.asarray([50])).tolist() == [int(100 * math.exp(-0.5))]


@pytest.mark.parametrize("fmt", ["pair", "row"])
def test_clustering_matches_reference(tmp_path, fmt):
    ids = ["A", "B", "C", "X", "Y", "Z"]
    close = {("A", "B"), ("A", "C"), ("B", "C"), ("X", "Y"), ("Y", "Z")}
    d = {(a, b): (10 if (a, b) in close else 950)
         for i, a in enumerate(ids) for b in ids[i + 1:]}
    if fmt == "pair":
        lines = [f"{a},{b},{v}" for (a, b), v in d.items()]
    else:
        lines = [",".join([a] + [f"{b},{d.get((a, b), d.get((b, a)))}"
                                 for b in ids if b != a]) for a in ids]
    write_output(str(tmp_path / "dist"), lines)
    write_output(str(tmp_path / "in"), [f"{e},x" for e in ids])
    cfg = {"min.av.edge.weight.threshold": "600",
           "distance.file.path": str(tmp_path / "dist"),
           "distance.file.format": fmt, "distance.scale": "1000", "seed": "3"}
    jc, pc, _, pout = _pair(tmp_path,
                            jcl.AgglomerativeGraphical(JaxConfig(cfg)),
                            tcl.AgglomerativeGraphical(JobConfig(dict(cfg)),
                                                       device="cpu"),
                            str(tmp_path / "in"), "clusters")
    assert pc.as_dict() == jc.as_dict()
    assert pc.get("Cluster", "clusters") == 2
    for reader in ("from_pair_file", "from_row_file"):
        assert (getattr(tcl.EntityDistanceStore, reader)(
            str(tmp_path / "dist")).rows
            == getattr(jcl.EntityDistanceStore, reader)(
                str(tmp_path / "dist")).rows)


def test_blobs_datagen_matches_reference(tmp_path):
    assert datagen.gen_blobs(120, seed=41) == _blobs(120, seed=41)
    out = tmp_path / "all.csv"
    assert datagen.main(["blobs", "120", "--seed", "41",
                         "--out", str(out)]) == 0
    assert out.read_text() == "\n".join(
        ",".join(r) for r in _blobs(120, seed=41)) + "\n"


def test_cli_registers_the_reference_names():
    for fq, (module, cls, prefix) in {
            "org.sifarish.feature.SameTypeSimilarity":
                ("knn", "SameTypeSimilarity", ""),
            "org.avenir.knn.FeatureCondProbJoiner":
                ("knn", "FeatureCondProbJoiner", ""),
            "org.avenir.knn.NearestNeighbor": ("knn", "NearestNeighbor", ""),
            "org.avenir.cluster.AgglomerativeGraphical":
                ("cluster", "AgglomerativeGraphical", "")}.items():
        assert cli.resolve(fq) == cli.resolve(fq.rsplit(".", 1)[1]) \
            == (module, cls, prefix)
        assert jax_cli.resolve(fq) == (module, cls, prefix)


def _runbook(pkg_main, work, extra):
    """resource/knn_classify/run.sh, step by step, from the runbook's
    directory (its properties name ``blobs.json`` relatively)."""
    os.makedirs(f"{work}/inp")
    os.makedirs(f"{work}/train")
    os.makedirs(f"{work}/pprob")
    rows = [",".join(r) for r in datagen.gen_blobs(120, seed=41)]
    with open(f"{work}/inp/tr-00000", "w") as fh:
        fh.write("\n".join(rows[:100]) + "\n")
    with open(f"{work}/inp/te-00000", "w") as fh:
        fh.write("\n".join(rows[-20:]) + "\n")
    shutil.copy(f"{work}/inp/tr-00000", f"{work}/train/part-00000")
    steps = [
        ["SameTypeSimilarity", "-Dconf.path=sim.properties",
         f"{work}/inp", f"{work}/simi"],
        ["NearestNeighbor", "-Dconf.path=knn.properties", f"{work}/simi",
         f"{work}/pred"],
        ["BayesianDistribution", "-Dconf.path=nb.properties",
         f"{work}/train", f"{work}/nbmodel"],
        ["BayesianPredictor", "-Dconf.path=nbprob.properties",
         f"-Dbayesian.model.file.path={work}/nbmodel", f"{work}/train",
         f"{work}/probs"],
        ["FeatureCondProbJoiner", "-Dconf.path=join.properties",
         f"{work}/simi,{work}/pprob", f"{work}/join"],
        ["NearestNeighbor", "-Dconf.path=knnw.properties", f"{work}/join",
         f"{work}/predw"],
    ]
    for argv in steps:
        assert pkg_main(argv + extra) == 0, argv
        if argv[0] == "BayesianPredictor":
            shutil.copy(f"{work}/probs/part-r-00000",
                        f"{work}/pprob/prDistr-r-00000")


def test_knn_runbook_through_cli_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(RUNBOOK)
    _runbook(jax_cli.main, str(tmp_path / "jax"), [])
    _runbook(cli.main, str(tmp_path / "port"), ["--device", "cpu"])
    for out in ("simi", "pred", "nbmodel", "probs", "join", "predw"):
        want = _read(tmp_path / "jax" / out)
        assert want and _read(tmp_path / "port" / out) == want, out
