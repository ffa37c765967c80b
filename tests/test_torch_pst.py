"""The port's suffix-tree counts (``avenir_tpu_torch/models/pst.py``) and
its halo window counter (``ops.counting.sharded_ngram_counts``) held
against the JAX package's on the CPU.

``resource/visit_pst`` runs through both command lines on the same seeded
rows.  ``sharded_ngram_counts`` runs on the port's 8- and 1-position CPU
meshes (and one device) against the reference on ``mesh8`` and ``mesh1``:
segmented and not, windows of 2-4, -1 gaps, lengths that 8 does not
divide, and chunks shorter than a window.  The job runs sequential and
sessionized, on a mesh, and over the host fallback under a lowered
``_DENSE_CAP`` (patched in the port's module only).  Counts are
integers: every comparison is equality.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.datagen import gen_visit_history
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import pst as jp
from avenir_tpu.ops.counting import sharded_ngram_counts as jax_ngrams

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import pst as tp
from avenir_tpu_torch.ops.counting import sharded_ngram_counts
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK = os.path.join(REPO, "resource", "visit_pst")
CPU = torch.device("cpu")


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _runbook(work, main, dg, extra=()):
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert dg(["visit_history", "800", "--seed", "7",
                   "--out", "work/in/part-00000"]) == 0
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["ProbabilisticSuffixTreeGenerator",
                       f"-Dconf.path={BOOK}/pst.properties", "work/in",
                       "work/out", *extra])
        assert rc in (0, None), err.getvalue()
    finally:
        os.chdir(cwd)


def test_runbook_byte_identical(tmp_path):
    _runbook(str(tmp_path / "jax"), jax_main, jax_datagen)
    _runbook(str(tmp_path / "port"), port_main, datagen.main,
             extra=("--device", "cpu"))
    got = _read(tmp_path / "port" / "work" / "out")
    assert got == _read(tmp_path / "jax" / "work" / "out")
    assert got.count(b"\n") > 100


# ---------------------------------------------------------------------------
# the halo window counter
# ---------------------------------------------------------------------------

def _stream(L, V, seed, gaps=True, n_seg=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, L).astype(np.int32)
    if gaps:
        toks[rng.random(L) < 0.1] = -1
    seg = np.sort(rng.integers(0, n_seg, L)).astype(np.int32)
    return toks, seg


CASES = [
    # (length, vocab, w, segmented, gaps)
    (1003, 5, 2, False, True),      # 8 does not divide the length
    (1003, 5, 3, True, True),
    (517, 4, 4, True, False),
    (64, 3, 3, False, False),       # divides evenly
    (13, 3, 4, True, True),         # 2-token chunks: shorter than w
    (5, 2, 3, False, False),        # fewer tokens than positions
    (0, 2, 2, False, False),        # nothing to count
]


@pytest.mark.parametrize("L,V,w,segged,gaps", CASES)
def test_ngram_counts_match_reference(mesh8, mesh1, L, V, w, segged, gaps):
    n_seg = 3 if segged else 1
    toks, seg = _stream(L, V, L + w, gaps, n_seg)
    kw = {"seg": seg, "n_seg": n_seg} if segged else {}
    want8 = np.asarray(jax_ngrams(toks, V, w, mesh=mesh8, **kw))
    want1 = np.asarray(jax_ngrams(toks, V, w, mesh=mesh1, **kw))
    np.testing.assert_array_equal(want8, want1)
    for where in ({"mesh": pmesh.make_mesh([CPU] * 8)},
                  {"mesh": pmesh.make_mesh([CPU] * 8, data=2, model=4)},
                  {"mesh": pmesh.make_mesh([CPU])}, {"device": CPU}):
        got = sharded_ngram_counts(toks, V, w, **kw, **where)
        assert got.dtype == torch.int32 and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), want8)


def test_windows_never_cross_a_gap_or_a_segment():
    toks = np.asarray([0, 1, -1, 1, 0, 0, 1], dtype=np.int32)
    seg = np.asarray([0, 0, 0, 1, 1, 2, 2], dtype=np.int32)
    got = sharded_ngram_counts(toks, 2, 2, seg=seg, n_seg=3,
                               mesh=pmesh.make_mesh([CPU] * 4))
    want = np.zeros((3, 2, 2), np.int32)
    want[0, 0, 1] = want[1, 1, 0] = want[2, 0, 1] = 1
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def visits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pst")
    rows = [",".join(r) for r in gen_visit_history(300, conv_rate=50,
                                                   label=True, seed=11)]
    write_output(str(tmp / "in"), rows)
    # one event per row: userId,label,state (the sessionized layout)
    events = [f"{r.split(',')[0]},{r.split(',')[1]},{s}"
              for r in rows for s in r.split(",")[2:]]
    write_output(str(tmp / "events"), events)
    return tmp


SEQ = {"skip.field.count": "2", "class.label.field.ord": "1",
       "max.seq.length": "4"}
SESS = {"input.format.sequential": "false", "id.field.ordinals": "0",
        "class.label.field.ord": "1", "data.field.ordinal": "2",
        "max.seq.length": "3"}


@pytest.mark.parametrize("name,props,inp", [
    ("sequential", SEQ, "in"),
    ("sequential-ids", dict(SEQ, **{"id.field.ordinals": "0",
                                    "max.seq.length": "2"}), "in"),
    ("sessionized", SESS, "events"),
])
def test_job_matches_reference(visits, mesh8, name, props, inp):
    jp.ProbabilisticSuffixTreeGenerator(JaxConfig(dict(props))).run(
        str(visits / inp), str(visits / f"{name}_jax"), mesh=mesh8)
    want = _read(visits / f"{name}_jax")
    for tag, m in (("one", None), ("mesh", pmesh.make_mesh([CPU] * 8))):
        counters = tp.ProbabilisticSuffixTreeGenerator(
            JobConfig(dict(props)), device="cpu").run(
            str(visits / inp), str(visits / f"{name}_{tag}"), mesh=m)
        assert _read(visits / f"{name}_{tag}") == want, tag
        assert counters.get("PST", "HostFallbackWindows") == 0
    assert want


def test_host_fallback_above_the_dense_cap(visits, mesh8, monkeypatch):
    """With the cap lowered, windows of length 3 and 4 fall back to the
    host count (its counter shows them) and the bytes do not move."""
    jp.ProbabilisticSuffixTreeGenerator(JaxConfig(dict(SEQ))).run(
        str(visits / "in"), str(visits / "cap_jax"), mesh=mesh8)
    monkeypatch.setattr(tp, "_DENSE_CAP", 2 * 9 * 9 * 9 - 1)
    counters = tp.ProbabilisticSuffixTreeGenerator(
        JobConfig(dict(SEQ)), device="cpu").run(
        str(visits / "in"), str(visits / "cap_port"))
    assert _read(visits / "cap_port") == _read(visits / "cap_jax")
    assert counters.get("PST", "HostFallbackWindows") > 0
    monkeypatch.setattr(tp, "_DENSE_CAP", 10)      # every length falls back
    counters = tp.ProbabilisticSuffixTreeGenerator(
        JobConfig(dict(SEQ)), device="cpu").run(
        str(visits / "in"), str(visits / "cap_all"))
    assert _read(visits / "cap_all") == _read(visits / "cap_jax")
