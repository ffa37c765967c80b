"""The kNN distance job's columnar emit against its per-line emit.

``SameTypeSimilarity.run`` builds the pair lines as bytes from the
engine's ``(dist, idx)`` arrays and the columnar reader's byte columns
(``_write_pair_columns``) where the columnar reader took the input and
``field.delim.out`` is ASCII; the Python reader's sets take the per-line
loop (``_pair_lines``).  Here the same input runs twice through the
columnar reader, with the same engine answer: once as it is, once with
the reader's byte columns turned into lists of text, which sends the job
to the per-line loop.  Both give the same part file, ``_MANIFEST``,
``_SUCCESS`` and counters:

- the cell's settings (inter-set, ``output.top.matches``); a self-join
  with top-k whose duplicated rows put a row's own index after its ties,
  or past its candidates; dense output, inter-set and self-join, one
  block of test rows and many; no class attributes; ids of unequal
  widths; distances of 0, of one digit and of six; a
  multi-character output delimiter; an artifact store that wants the
  output, with the file written and without;
- ``COLUMNAR_EMITS`` counts a columnar job and neither a job on the
  Python reader's input nor one with a delimiter that is not ASCII, and
  those give the same bytes;
- ``_decimal``'s text is ``str(int)`` for every sign and width.

The planted fault for the emit (a training id gathered one row off) is
with the other kNN faults in ``test_torch_knn_columnar.py``.
"""

from pathlib import Path

import numpy as np
import pytest

from avenir_tpu_torch import datagen
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import ArtifactStore, set_artifact_store
from avenir_tpu_torch.models import knn as tk

ROOT = Path(__file__).resolve().parent.parent
SCHEMA = str(ROOT / "resource" / "elearn_nb" / "elearn.json")


def _rows(n, seed, ids):
    """Seeded e-learning rows with the ids ``ids(i)``."""
    rows = datagen.gen_elearn(n, seed=seed)
    for i, r in enumerate(rows):
        r[0] = ids(i)
    return rows


def _text(rows):
    return "".join(",".join(r) + "\n" for r in rows)


def _inter(n_train, n_test, seed, train_ids=None, test_ids=None):
    rows = _rows(n_train + n_test, seed, lambda i: f"U{i}")
    for i, r in enumerate(rows[:n_train]):
        r[0] = (train_ids or (lambda j: f"T{j:07d}"))(i)
    for i, r in enumerate(rows[n_train:]):
        r[0] = (test_ids or (lambda j: f"Q{j:07d}"))(i)
    return {"tr-00000": _text(rows[:n_train]),
            "te-00000": _text(rows[n_train:])}


def _self_join(n, seed):
    """``n`` rows in one training file; rows 10-14 copy row 5's
    features, so rows 5 and 10-14 are at distance 0 from each other and
    each later one's own index comes after its ties, or past its top-k
    candidates (lowest index first on ties)."""
    rows = _rows(n, seed, lambda i: f"S{i:05d}")
    for i in range(10, 15):
        rows[i][1:] = rows[5][1:]
    return {"tr-00000": _text(rows)}


def _digits():
    """Distances of 0 (a test row equal to a training row), of one
    digit (a test row 5 units off one in a feature of range 700) and of
    six (a test row whose feature lies a thousand ranges out)."""
    rows = _rows(70, 21, lambda i: f"T{i:07d}")
    train, test = rows[:60], rows[60:]
    test[0][1:] = train[3][1:]
    test[1][1:] = train[4][1:]
    test[1][1] = str(int(train[4][1]) + 5)
    test[2][1] = "700000"
    for i, r in enumerate(test):
        r[0] = f"Q{i:07d}"
    return {"tr-00000": _text(train), "te-00000": _text(test)}


TOP5 = {"output.top.matches": "5", "distance.scale": "1000"}
CASES = {
    "cell": (lambda: _inter(300, 40, 1), TOP5, {}),
    "self_join_ties": (lambda: _self_join(80, 2),
                       {"inter.set.matching": "false",
                        "output.top.matches": "3"}, {"ties": True}),
    "self_join_ties_blocks": (lambda: _self_join(80, 2),
                              {"inter.set.matching": "false",
                               "output.top.matches": "3"},
                              {"block": 9, "ties": True}),
    "dense": (lambda: _inter(50, 6, 3), {}, {}),
    "dense_self_join": (lambda: _self_join(30, 4),
                        {"inter.set.matching": "false"}, {}),
    "dense_blocks": (lambda: _self_join(30, 4),
                     {"inter.set.matching": "false"}, {"block": 70}),
    "no_class": (lambda: _inter(120, 20, 5),
                 dict(TOP5, **{"include.class.attributes": "false"}), {}),
    "unequal_ids": (lambda: _inter(
        120, 20, 6, lambda j: (("T1", "T10", "T1000000")[j] if j < 3
                               else f"T{10 ** (j % 7) + j}"),
        lambda j: f"Q{j}" if j % 2 else f"Q{j * 100003}"), TOP5,
        {"widths": True}),
    "digits": (_digits, TOP5, {"digits": True}),
    "delim": (lambda: _inter(120, 20, 7),
              dict(TOP5, **{"field.delim.out": "::"}), {}),
    "store": (lambda: _inter(120, 20, 8), TOP5, {"store": True}),
    "store_memory_only": (lambda: _inter(120, 20, 8), TOP5,
                          {"store": False}),
}


def _as_text(read):
    """The columnar reader's sets with their byte columns as lists of
    text, as the Python reader gives them."""
    def text(col):
        return None if col is None else [v.decode() for v in col]
    return read._replace(train_ids=text(read.train_ids),
                         test_ids=text(read.test_ids),
                         train_cls=text(read.train_cls),
                         test_cls=text(read.test_cls))


def _run(tmp, tag, props, monkeypatch, per_line=False, block=None):
    """The distance job on ``tmp / 'in'`` through the columnar reader,
    into ``tmp / tag``; ``per_line`` hands the emit lists of text;
    ``block`` sets the columnar emit's block.  Returns the counters."""
    orig = tk.SameTypeSimilarity._read_columns
    took = []

    def reader(self, *a):
        got = orig(self, *a)
        took.append(got is not None)
        return _as_text(got) if per_line else got
    with monkeypatch.context() as m:
        m.setattr(tk.SameTypeSimilarity, "_read_columns", reader)
        if block is not None:
            m.setattr(tk, "_EMIT_BLOCK_PAIRS", block)
        before = tk.COLUMNAR_EMITS
        counters = tk.SameTypeSimilarity(
            JobConfig(dict(props, **{"feature.schema.file.path": SCHEMA})),
            device="cpu").run(str(tmp / "in"), str(tmp / tag))
        assert took == [True]
        assert tk.COLUMNAR_EMITS - before == int(not per_line)
    return counters


def _files(out):
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


@pytest.mark.parametrize("case", sorted(CASES))
def test_columnar_emit_matches_the_per_line_emit(case, tmp_path,
                                                 monkeypatch):
    parts, props, how = CASES[case]
    (tmp_path / "in").mkdir()
    for name, text in parts().items():
        (tmp_path / "in" / name).write_text(text)
    store = None
    if "store" in how:
        store = ArtifactStore()
        for tag in ("col", "line"):
            store.register(str(tmp_path / tag), sink_file=how["store"])
    prev = set_artifact_store(store)
    try:
        col = _run(tmp_path, "col", props, monkeypatch,
                   block=how.get("block"))
        line = _run(tmp_path, "line", props, monkeypatch, per_line=True)
    finally:
        set_artifact_store(prev)
    assert col.as_dict() == line.as_dict()
    pairs = col.get("Basic", "Pairs emitted")
    if store is None or how["store"]:
        got, want = _files(tmp_path / "col"), _files(tmp_path / "line")
        assert sorted(got) == ["_MANIFEST", "_SUCCESS", "part-r-00000"]
        assert got == want
        text = got["part-r-00000"]
        assert text.count(b"\n") == pairs > 0
    else:
        assert not (tmp_path / "col").exists()
        assert not (tmp_path / "line").exists()
    if store is not None:
        lines = store.peek(str(tmp_path / "col"))
        assert lines == store.peek(str(tmp_path / "line"))
        assert lines == store.peek(str(tmp_path / "col" / "part-r-00000"))
        assert len(lines) == pairs
        text = "".join(f"{x}\n" for x in lines).encode()
    delim = props.get("field.delim.out", ",").encode()
    fields = [ln.split(delim) for ln in text.splitlines()]
    assert {len(f) for f in fields} == {
        3 if "include.class.attributes" in props else 5}
    if how.get("digits"):
        dist = {int(f[2]) for f in fields}
        assert 0 in dist
        assert any(0 < d < 10 for d in dist)
        assert any(d >= 100000 for d in dist)
    if how.get("widths"):
        assert len({len(f[0]) for f in fields}) > 2
        assert len({len(f[1]) for f in fields}) > 2
    if how.get("ties"):
        # row 12's candidates: rows 5, 10, 11, then itself, skipped
        assert [f[0] for f in fields if f[1] == b"S00012"] == [
            b"S00005", b"S00010", b"S00011"]
        assert {f[2] for f in fields if f[1] == b"S00012"} == {b"0"}
    if props.get("inter.set.matching") == "false":
        assert all(f[0] != f[1] for f in fields)


@pytest.mark.parametrize("reader,delim,columnar", [
    ("columnar", ",", True), ("python", ",", False),
    ("columnar", "¦", False)],
    ids=["columnar", "python_reader", "non_ascii_delim"])
def test_columnar_emits_counts_the_columnar_jobs(tmp_path, monkeypatch,
                                                 reader, delim, columnar):
    """``COLUMNAR_EMITS`` counts one a job that took the columnar emit
    and none on the Python reader's input or with a delimiter that is
    not ASCII; every one gives the Python reader's bytes."""
    (tmp_path / "in").mkdir()
    for name, text in _inter(100, 15, 9).items():
        (tmp_path / "in" / name).write_text(text)
    conf = JobConfig(dict(TOP5, **{"feature.schema.file.path": SCHEMA,
                                   "field.delim.out": delim}))
    before = tk.COLUMNAR_EMITS
    with monkeypatch.context() as m:
        if reader == "python":
            m.setattr(tk.SameTypeSimilarity, "_read_columns",
                      lambda self, *a: None)
        tk.SameTypeSimilarity(conf, device="cpu").run(
            str(tmp_path / "in"), str(tmp_path / "got"))
    assert tk.COLUMNAR_EMITS - before == int(columnar)
    with monkeypatch.context() as m:
        m.setattr(tk.SameTypeSimilarity, "_read_columns",
                  lambda self, *a: None)
        tk.SameTypeSimilarity(conf, device="cpu").run(
            str(tmp_path / "in"), str(tmp_path / "want"))
    assert tk.COLUMNAR_EMITS - before == int(columnar)
    got = (tmp_path / "got" / "part-r-00000").read_bytes()
    assert got == (tmp_path / "want" / "part-r-00000").read_bytes()
    assert got.count(b"\n") == 5 * 15


def test_decimal_is_the_text_of_each_integer():
    rng = np.random.default_rng(5)
    values = np.concatenate([
        np.array([0, 1, -1, 9, -9, 10, -10, 99, 100, 99999, 100000,
                  -123456, 2 ** 31 - 1, -2 ** 31], np.int64),
        rng.integers(-10 ** 6, 10 ** 6, 200)]).astype(np.int32)
    text = tk._decimal(values)
    assert text.dtype == np.uint8 and text.shape[0] == len(values)
    got = [bytes(row[row != 0]).decode() for row in text]
    assert got == [str(int(v)) for v in values]
    assert bytes(tk._decimal(np.zeros(3, np.int32)).reshape(-1)
                 ).replace(b"\0", b"") == b"000"
