"""The vote job's columnar path against its per-group path.

``NearestNeighbor.run`` reads the pair lines by column and decides every
neighbourhood at once (``_vote_columns``) where the settings and the
input allow; else each line is split and grouped (``_map``) and each
group decided by ``classify_group`` (``_vote``).  On the same pair lines
both give the same prediction bytes and the same counters:

- the pair lines of the e-learning cell's distance job at the cell's
  settings, and seeded pair lines with ties in distance, ties in the
  class sums, scores that are never above 0, interleaved test ids,
  groups shorter and longer than ``top.match.count``, classes and ids of
  several widths, a test class that differs within a group; each
  kernel with validation on and off;
- each input or setting the columnar path leaves to the per-group one
  gives the same bytes or the same exception, and ``COLUMNAR_VOTES``
  does not move;
- four planted faults in the columnar path, each caught by the
  comparison: an unstable sort by distance, a class tie broken to the
  later class, the (k+1)-th neighbour counted, the test class taken
  from a group's first line.
"""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest

from avenir_tpu_torch.cli import main as cli_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import (ArtifactStore, set_artifact_store,
                                      write_output)
from avenir_tpu_torch.models import knn as tk

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402

GEN = common.load_module(BENCH / "gen" / "knn_elearn.py", "knn_elearn_gen")
SCHEMA = str(ROOT / "resource" / "elearn_nb" / "elearn.json")
#: the cell's knn.properties
CELL = {"top.match.count": "5", "validation.mode": "true",
        "kernel.function": "none"}


def _pairs(seed, n_groups=60, sizes=(5, 5), dist=(0, 400),
           classes=("P", "F"), by_distance=True, interleave=False,
           test_class_varies=False, id_fmt="Q{:07d}"):
    """Seeded pair lines ``trainId, testId, distance, trainClass,
    testClass``: ``sizes`` bounds a group's lines, ``dist`` its
    distances (sorted where ``by_distance``), ``classes`` the classes."""
    rng = np.random.default_rng(seed)
    groups = []
    for q in range(n_groups):
        m = int(rng.integers(sizes[0], sizes[1] + 1))
        d = rng.integers(dist[0], dist[1], m)
        if by_distance:
            d = np.sort(d)
        own = classes[rng.integers(len(classes))]
        groups.append([
            f"T{int(rng.integers(10 ** 6)):07d},{id_fmt.format(q)},{x},"
            f"{classes[rng.integers(len(classes))]},"
            f"{classes[rng.integers(len(classes))] if test_class_varies else own}"
            for x in d])
    if not interleave:
        return [line for g in groups for line in g]
    lines = []
    while any(groups):
        for g in groups:
            if g and rng.random() < 0.6:
                lines.append(g.pop(0))
    return lines


def _cell_pairs(tmp):
    """The cell's distance job over 1,500 training x 120 test rows of the
    benchmark's generator."""
    data = GEN.make(2 ** 31 + 77, 1500, 120)
    inp = tmp / "in"
    inp.mkdir()
    (inp / "tr-00000").write_bytes(GEN.csv_bytes(data["train"], b"T"))
    (inp / "te-00000").write_bytes(GEN.csv_bytes(data["pool"], b"Q"))
    (tmp / "sim.properties").write_text(
        f"feature.schema.file.path={SCHEMA}\nbase.set.split.prefix=tr\n"
        "output.top.matches=5\ndistance.scale=1000\n")
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli_main(["SameTypeSimilarity",
                         f"-Dconf.path={tmp / 'sim.properties'}", str(inp),
                         str(tmp / "sim"), "--device", "cpu"]) == 0
    return (tmp / "sim" / "part-r-00000").read_text().splitlines()


def _outcome(props, in_path, out_path, per_group=False, fault=None,
             monkeypatch=None):
    """One vote job: ``("ok", bytes, counters, columnar)`` or
    ``("raised", type, message, columnar)``, ``columnar`` the change of
    ``COLUMNAR_VOTES``.  ``per_group`` sends the job to ``_map`` and
    ``_vote``; ``fault`` plants a fault in the columnar path."""
    job = tk.NearestNeighbor(JobConfig(dict(props, **{
        "feature.schema.file.path": SCHEMA})), device="cpu")
    if per_group:
        job._read_bytes = lambda *a: None
    if fault is not None:
        fault(monkeypatch, job)
    before = tk.COLUMNAR_VOTES
    try:
        counters = job.run(str(in_path), str(out_path))
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return ("raised", type(e), str(e), tk.COLUMNAR_VOTES - before)
    return ("ok", (Path(out_path) / "part-r-00000").read_bytes(),
            counters.as_dict(), tk.COLUMNAR_VOTES - before)


def _both(tmp, lines, props):
    write_output(str(tmp / "pairs"), lines)
    return (_outcome(props, tmp / "pairs", tmp / "col"),
            _outcome(props, tmp / "pairs", tmp / "grp", per_group=True))


#: (pair lines, settings other than the cell's)
CASES = {
    "ties_in_distance": (dict(sizes=(6, 9), dist=(0, 4),
                              by_distance=False), {}),
    "ties_in_class_sums": (dict(sizes=(4, 4), dist=(0, 50)),
                           {"top.match.count": "4"}),
    "interleaved_ids": (dict(sizes=(3, 8), interleave=True), {}),
    "short_and_long_groups": (dict(sizes=(1, 12), by_distance=False), {}),
    "classes_and_ids_of_other_widths": (dict(
        sizes=(3, 9), dist=(0, 6), classes=("P", "F", "gamma12", "dd",
                                            "eeeeeeeeeee"),
        id_fmt="user{:05d}z"), {}),
    "test_class_differs_in_a_group": (dict(
        sizes=(2, 7), interleave=True, test_class_varies=True), {}),
    # scores past 2^53, whose float64 sums depend on their order
    "distances_of_int64_scale": (dict(
        sizes=(3, 9), dist=(-10 ** 17, 10 ** 17), by_distance=False),
        {"kernel.function": "linearAdditive"}),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["cell"])
def test_columnar_vote_matches_per_group(case, tmp_path):
    if case == "cell":
        lines, props = _cell_pairs(tmp_path), CELL
    else:
        lines = _pairs(sorted(CASES).index(case) + 11, **CASES[case][0])
        props = dict(CELL, **CASES[case][1])
    col, grp = _both(tmp_path, lines, props)
    assert col[0] == "ok" and col[3] == 1 and grp[3] == 0, (col, grp)
    assert col[1:3] == grp[1:3]
    assert col[1].count(b"\n") == len({ln.split(",")[1] for ln in lines})
    if case == "ties_in_class_sums":
        # groups of four lines at k = 4, some of them two P and two F:
        # the class seen first decides those
        per_group = {}
        for ln in lines:
            f = ln.split(",")
            per_group.setdefault(f[1], []).append(f[3])
        assert any(c.count("P") == 2 for c in per_group.values())


@pytest.mark.parametrize("validation", ["true", "false"])
@pytest.mark.parametrize("kernel,param", [
    ("none", "-1"), ("linearMultiplicative", "-1"),
    ("linearAdditive", "-1"), ("gaussian", "30")])
def test_columnar_vote_matches_per_group_per_kernel(kernel, param,
                                                    validation, tmp_path):
    lines = _pairs(5, sizes=(2, 9), dist=(0, 140), interleave=True,
                   by_distance=False)
    props = {"top.match.count": "5", "validation.mode": validation,
             "kernel.function": kernel, "kernel.param": param}
    col, grp = _both(tmp_path, lines, props)
    assert col[0] == "ok" and col[3] == 1, col
    assert col[1:3] == grp[1:3]


def test_scores_never_above_zero_predict_nothing(tmp_path):
    """``linearAdditive`` at distances of 100 and more: no class sum is
    above 0, so every prediction is empty, as ``_classify`` gives it
    (without validation: with no positive prediction the precision
    divides by zero, on both paths)."""
    lines = _pairs(6, sizes=(3, 6), dist=(100, 300))
    col, grp = _both(tmp_path, lines, dict(
        CELL, **{"kernel.function": "linearAdditive",
                 "validation.mode": "false"}))
    assert col[0] == "ok" and col[3] == 1 and col[1:3] == grp[1:3]
    assert all(ln.endswith(",") for ln in col[1].decode().splitlines())


def test_float_sums_round_as_per_group(tmp_path):
    """``linearAdditive`` scores past 2^53, summed in float64 in rank
    order as the per-group dict sums them: ``Q1``'s 2^55, 3, 3, -2^55
    sum to 0 (each 3 is lost), so no prediction, where an exact sum (6)
    gives P; ``Q2``'s F (2^55 + 3) and P (2^55 + 4) both round to 2^55,
    so F, seen first, wins, where exact sums give P."""
    big = 2 ** 55
    lines = [f"T1,Q1,{100 - big},P,P", "T2,Q1,97,P,P", "T3,Q1,97,P,P",
             f"T4,Q1,{100 + big},P,P",
             f"T5,Q2,{100 - big},F,F", f"T6,Q2,{100 - big},P,F",
             "T7,Q2,96,P,F", "T8,Q2,97,F,F"]
    col, grp = _both(tmp_path, lines, {
        "top.match.count": "4", "validation.mode": "false",
        "kernel.function": "linearAdditive"})
    assert col[0] == "ok" and col[3] == 1 and col[1:3] == grp[1:3]
    assert col[1] == b"Q1,\nQ2,F\n"


def _store_held(tmp, lines):
    """The pair lines held in an artifact store, with no file."""
    store = ArtifactStore()
    store.register(str(tmp / "pairs"), sink_file=False)
    prev = set_artifact_store(store)
    write_output(str(tmp / "pairs"), lines)
    return prev


def _distance_of_line(i, text):
    """A change of the pair lines: line ``i``'s distance set to ``text``."""
    def change(lines):
        f = lines[i].split(",")
        f[2] = text
        return lines[:i] + [",".join(f)] + lines[i + 1:]
    return change


#: (name, props, how the pair lines are changed)
FALLBACKS = [
    ("regression", {"prediction.mode": "regression",
                    "regression.method": "average"},
     lambda ls: [",".join(x.split(",")[:3] + [str(i % 50), str(i % 9)])
                 for i, x in enumerate(ls)]),
    ("class_condition_weighted", {"class.condition.weighted": "true"},
     lambda ls: [f"{f[1]},{f[4]},{f[0]},{f[2]},{f[3]},0.{i % 9 + 1}"
                 for i, f in enumerate(x.split(",") for x in ls)]),
    ("class_distribution", {"output.class.distr": "true"}, None),
    ("decision_threshold", {"decision.threshold": "1.5",
                            "class.attribute.values": "F,P"}, None),
    ("cost_based", {"use.cost.based.classifier": "true",
                    "class.attribute.values": "F,P",
                    "misclassification.cost": "3,1"}, None),
    ("no_neighbour_counted", {"top.match.count": "0"}, None),
    ("regex_delimiter", {"field.delim.regex": "[,;]"}, None),
    ("ragged_row", {}, lambda ls: ls[:7] + [ls[7] + ",extra"] + ls[8:]),
    ("float_distance", {}, _distance_of_line(9, "5.0")),
    ("distance_past_int64", {}, _distance_of_line(3, "9" * 20)),
    ("sign_without_digits", {}, _distance_of_line(4, "- ")),
    ("crlf_line_ends", {}, lambda ls: [x + "\r" for x in ls]),
    ("not_ascii", {}, lambda ls: [x.replace("P", "\u00de") for x in ls]),
    ("artifact_store", {}, "store"),
]


@pytest.mark.parametrize("name,props,change", FALLBACKS,
                         ids=[f[0] for f in FALLBACKS])
def test_fallback_keeps_the_per_group_outcome(name, props, change,
                                              tmp_path):
    lines = _pairs(9, n_groups=30, sizes=(3, 7), by_distance=False)
    if callable(change):
        lines = change(lines)
    props = dict(CELL, **props)
    prev = None
    if change == "store":
        prev = _store_held(tmp_path, lines)
        assert not (tmp_path / "pairs").exists()
    else:
        write_output(str(tmp_path / "pairs"), lines)
    try:
        col = _outcome(props, tmp_path / "pairs", tmp_path / "col")
        grp = _outcome(props, tmp_path / "pairs", tmp_path / "grp",
                       per_group=True)
    finally:
        if change == "store":
            set_artifact_store(prev)
    assert col[3] == 0 and grp[3] == 0, (col, grp)
    assert col[:3] == grp[:3]
    if name in ("float_distance", "sign_without_digits"):
        assert col[:2] == ("raised", ValueError)


def _unstable_sort(monkeypatch, job):
    """Ties in distance taken in reverse arrival order."""
    monkeypatch.setattr(tk, "_stable_order", lambda grp, dist: np.lexsort(
        (-np.arange(len(grp)), dist, grp)))


def _class_tie_to_later(monkeypatch, job):
    winners = tk._winners
    monkeypatch.setattr(tk, "_winners", lambda pair, seen, total, n_cls:
                        winners(pair, -seen, total, n_cls))


def _next_neighbour_counted(monkeypatch, job):
    monkeypatch.setattr(job, "top_match_count", job.top_match_count + 1)


def _test_class_of_first_line(monkeypatch, job):
    monkeypatch.setattr(tk, "_last_rows",
                        lambda order, start: np.minimum.reduceat(order,
                                                                 start))


@pytest.mark.parametrize("fault", [
    _unstable_sort, _class_tie_to_later, _next_neighbour_counted,
    _test_class_of_first_line])
def test_planted_fault_is_caught(fault, tmp_path, monkeypatch):
    """Each fault in the columnar path changes the prediction bytes or
    the counters against the per-group path, on pair lines with ties in
    distance and in the class sums, groups longer than k and a test
    class that differs within a group."""
    lines = _pairs(21, n_groups=80, sizes=(4, 9), dist=(0, 5),
                   by_distance=False, interleave=True,
                   test_class_varies=True)
    write_output(str(tmp_path / "pairs"), lines)
    props = dict(CELL, **{"top.match.count": "4"})
    grp = _outcome(props, tmp_path / "pairs", tmp_path / "grp",
                   per_group=True)
    col = _outcome(props, tmp_path / "pairs", tmp_path / "col")
    assert col[1:3] == grp[1:3]
    bad = _outcome(props, tmp_path / "pairs", tmp_path / "bad",
                   fault=fault, monkeypatch=monkeypatch)
    assert bad[0] == "ok" and bad[3] == 1
    assert bad[1:3] != grp[1:3]


def test_columnar_votes_count_one_a_job(tmp_path):
    write_output(str(tmp_path / "pairs"), _pairs(3, n_groups=10))
    before = tk.COLUMNAR_VOTES
    for i in range(3):
        _outcome(CELL, tmp_path / "pairs", tmp_path / f"out{i}")
    assert tk.COLUMNAR_VOTES - before == 3
