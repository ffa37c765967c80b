"""The kNN distance job's columnar reader and its Python fallback, and
the e-learning kNN deployment held to the benchmark's plain reference.

- ``SameTypeSimilarity`` reads its part files through
  ``native.parse_csv_columns_buffer`` where it can, and through the
  Python split where it cannot; both give the same pair lines, byte for
  byte, and the vote job the same predictions: on seeded e-learning rows,
  with a categorical feature of undeclared values, with blank lines and
  several part files, and with a ragged row that sends the job to the
  Python reader.
- The program (the sorted engine on the CPU) against
  ``portbench/refs/knn_elearn.py`` at 4,000 training x 400 test rows:
  no pair outside the one-unit contract, no prediction differing.
- Four planted faults, each caught by that comparison: a distance off
  by two units, a neighbour swapped for one at least two units farther,
  a training id one row off in a pair line, a prediction flipped.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as cli_main
from avenir_tpu_torch.models import knn as tk

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402

GEN = common.load_module(BENCH / "gen" / "knn_elearn.py", "knn_elearn_gen")
REF = common.load_module(BENCH / "refs" / "knn_elearn.py", "knn_elearn_ref")
SCHEMA = json.loads((ROOT / "resource" / "elearn_nb" / "elearn.json")
                    .read_text())
K, SCALE = 5, 1000


def _write(tmp, schema, parts):
    """The schema, the properties of both jobs and the input part files
    (``{name: text}``) under ``tmp``."""
    (tmp / "schema.json").write_text(json.dumps(schema))
    (tmp / "sim.properties").write_text(
        f"feature.schema.file.path={tmp / 'schema.json'}\n"
        f"base.set.split.prefix=tr\noutput.top.matches={K}\n"
        f"distance.scale={SCALE}\n")
    (tmp / "knn.properties").write_text(
        f"feature.schema.file.path={tmp / 'schema.json'}\n"
        f"top.match.count={K}\nvalidation.mode=true\nkernel.function=none\n")
    inp = tmp / "in"
    inp.mkdir()
    for name, text in parts.items():
        (inp / name).write_text(text)


def _pipeline(tmp, tag, capsys):
    """Both jobs through the command line on the CPU: the pair bytes, the
    prediction bytes and the counters both printed."""
    capsys.readouterr()
    assert cli_main(["SameTypeSimilarity",
                     f"-Dconf.path={tmp / 'sim.properties'}", str(tmp / "in"),
                     str(tmp / f"sim{tag}"), "--device", "cpu"]) == 0
    assert cli_main(["NearestNeighbor",
                     f"-Dconf.path={tmp / 'knn.properties'}",
                     str(tmp / f"sim{tag}"), str(tmp / f"pred{tag}"),
                     "--device", "cpu"]) == 0
    return ((tmp / f"sim{tag}" / "part-r-00000").read_bytes(),
            (tmp / f"pred{tag}" / "part-r-00000").read_bytes(),
            capsys.readouterr().err)


def _text(rows):
    return "".join(",".join(r) + "\n" for r in rows)


def _elearn(n, seed):
    """Seeded e-learning rows with ids made unique."""
    rows = datagen.gen_elearn(n, seed=seed)
    for i, r in enumerate(rows):
        r[0] = f"U{i:05d}"
    return rows


def _categorical_case():
    """A categorical feature ``track`` (declared ``core``; ``lab`` and
    ``web`` undeclared, ``ext`` seen only in the test rows) after the
    status column."""
    schema = json.loads(json.dumps(SCHEMA))
    schema["fields"].append({"name": "track", "ordinal": 11,
                             "dataType": "categorical", "feature": True,
                             "cardinality": ["core"], "weight": 2.0})
    rows = _elearn(360, 11)
    rng = np.random.default_rng(4)
    for i, r in enumerate(rows):
        pool = ("web", "lab", "core") if i < 300 else ("lab", "ext", "core")
        r.append(pool[rng.integers(0, 3)])
    return schema, {"tr-00000": _text(rows[:300]),
                    "te-00000": _text(rows[300:])}


def _blank_lines_case():
    rows = _elearn(330, 12)
    tr = rows[:300]
    return SCHEMA, {"tr-00000": "\n" + _text(tr[:120]) + "\n\n",
                    "tr-00001": _text(tr[120:]).rstrip("\n"),
                    "te-00000": "\n\n" + _text(rows[300:]) + "\n"}


def _ragged_case():
    rows = _elearn(330, 13)
    rows[17] = rows[17] + ["extra"]        # one row with an extra field
    return SCHEMA, {"tr-00000": _text(rows[:300]),
                    "te-00000": _text(rows[300:])}


def _plain_case():
    rows = _elearn(400, 10)
    return SCHEMA, {"tr-00000": _text(rows[:360]),
                    "te-00000": _text(rows[360:])}


CASES = {"plain": _plain_case, "categorical": _categorical_case,
         "blank_lines": _blank_lines_case, "ragged": _ragged_case}
#: test rows of each case
TEST_ROWS = {"plain": 40, "categorical": 60, "blank_lines": 30, "ragged": 30}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_and_python_readers_agree(case, tmp_path, monkeypatch, capsys):
    schema, parts = CASES[case]()
    _write(tmp_path, schema, parts)
    took = []
    orig = tk.SameTypeSimilarity._read_columns

    def spy(self, *a):
        got = orig(self, *a)
        took.append(got is not None)
        return got
    monkeypatch.setattr(tk.SameTypeSimilarity, "_read_columns", spy)
    native = _pipeline(tmp_path, "n", capsys)
    assert took == [case != "ragged"]
    monkeypatch.setattr(tk.SameTypeSimilarity, "_read_columns",
                        lambda self, *a: None)
    python = _pipeline(tmp_path, "p", capsys)
    assert native[0] == python[0]
    assert native[1] == python[1]
    assert native[2] == python[2]
    assert native[0].count(b"\n") == K * TEST_ROWS[case]


@pytest.mark.parametrize("text", ["0x1f", "nan(7)"])
def test_text_float_refuses_goes_to_python(text, tmp_path, capsys):
    """Numbers ``strtod`` reads and ``float()`` refuses: the job fails as
    the Python reader does, with no output."""
    rows = _elearn(60, 14)
    rows[5][3] = text
    _write(tmp_path, SCHEMA, {"tr-00000": _text(rows[:50]),
                              "te-00000": _text(rows[50:])})
    with pytest.raises(ValueError):
        cli_main(["SameTypeSimilarity",
                  f"-Dconf.path={tmp_path / 'sim.properties'}",
                  str(tmp_path / "in"), str(tmp_path / "sim"),
                  "--device", "cpu"])
    assert not (tmp_path / "sim" / "part-r-00000").exists()


def test_first_seen_codes_follow_the_shared_vocabulary():
    vocab = {"core": 0}
    tr = np.array([b"web", b"core", b"lab", b"web"])
    te = np.array([b"ext", b"lab", b"zz"])
    a, b = tk._first_seen_codes(vocab, tr, te)
    assert a.tolist() == [1, 0, 2, 1] and b.tolist() == [3, 2, 4]
    assert vocab == {"core": 0, "web": 1, "lab": 2, "ext": 3, "zz": 4}


@pytest.fixture(scope="module")
def run_4000(tmp_path_factory):
    """The program's pipeline over 4,000 training x 400 test rows of the
    benchmark's generator, and the reference's k + 1 nearest."""
    tmp = tmp_path_factory.mktemp("knn_elearn")
    data = GEN.make(2 ** 31 + 2024, 4000, 400)
    train, test = data["train"], data["pool"]
    _write(tmp, SCHEMA, {"tr-00000": GEN.csv_bytes(train, b"T").decode(),
                         "te-00000": GEN.csv_bytes(test, b"Q").decode()})
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        for job, props, src, dst in (
                ("SameTypeSimilarity", "sim", "in", "sim"),
                ("NearestNeighbor", "knn", "sim", "pred")):
            assert cli_main([job, f"-Dconf.path={tmp / (props + '.properties')}",
                             str(tmp / src), str(tmp / dst),
                             "--device", "cpu"]) == 0
    dist, idx = REF.nearest(train, test, K + 1, SCALE)
    counters = {}
    for line in err.getvalue().splitlines():
        f = line.split("\t")
        if len(f) == 3 and f[0] == "Validation":
            counters[f[1]] = int(f[2])
    return {"train": train, "test": test, "dist": dist, "idx": idx,
            "pairs": (tmp / "sim" / "part-r-00000").read_text().splitlines(),
            "preds": (tmp / "pred" / "part-r-00000").read_text().splitlines(),
            "counters": counters}


def _judge(r, pairs=None, preds=None):
    pairs = r["pairs"] if pairs is None else pairs
    preds = r["preds"] if preds is None else preds
    got = REF.check_pairs(pairs, r["train"], r["test"], r["dist"][:, :K],
                          r["idx"][:, :K], SCALE)
    got["predictions_differing"] = REF.check_predictions(
        pairs, preds, r["counters"], K)
    return got


def test_program_against_reference(run_4000):
    got = _judge(run_4000)
    assert got["pairs_outside_contract"] == 0, got
    assert got["predictions_differing"] == 0, got
    assert got["rows_differing_share"] <= REF.LIMITS["rows_differing_share"]
    assert len(run_4000["preds"]) == 400
    assert sum(run_4000["counters"][n] for n in (
        "TruePositive", "FalseNegative", "TrueNagative",
        "FalsePositive")) == 400


def _distance_off_by_two(r):
    pairs = list(r["pairs"])
    f = pairs[7].split(",")
    f[2] = str(int(f[2]) + 2)
    pairs[7] = ",".join(f)
    return pairs, None


def _neighbour_swapped(r):
    """The k-th neighbour of the first test row whose (k+1)-th lies at
    least two units farther replaced by that (k+1)-th."""
    d = r["dist"]
    q = int(np.flatnonzero(d[:, K] - d[:, K - 1] >= 2)[0])
    t = int(r["idx"][q, K])
    pairs = list(r["pairs"])
    cls = REF.CLASSES
    pairs[q * K + K - 1] = (f"T{t:07d},Q{q:07d},{d[q, K]},"
                            f"{cls[r['train']['status'][t]]},"
                            f"{cls[r['test']['status'][q]]}")
    return pairs, None


def _training_id_off_by_one(r):
    """One line's training id gathered one row off, as an emit whose
    index into the training ids slipped would give it."""
    pairs = list(r["pairs"])
    f = pairs[7].split(",")
    f[0] = f"T{int(f[0][1:]) + 1:07d}"
    pairs[7] = ",".join(f)
    return pairs, None


def _prediction_flipped(r):
    preds = list(r["preds"])
    head, _, last = preds[3].rpartition(",")
    preds[3] = f"{head},{'P' if last == 'F' else 'F'}"
    return None, preds


@pytest.mark.parametrize("fault,caught_by", [
    (_distance_off_by_two, "pairs_outside_contract"),
    (_neighbour_swapped, "pairs_outside_contract"),
    (_training_id_off_by_one, "pairs_outside_contract"),
    (_prediction_flipped, "predictions_differing")])
def test_planted_fault_is_caught(run_4000, fault, caught_by):
    pairs, preds = fault(run_4000)
    got = _judge(run_4000, pairs, preds)
    assert got[caught_by] > REF.LIMITS[caught_by], got
