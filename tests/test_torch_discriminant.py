"""The port's ``NumericalAttrStats`` and ``FisherDiscriminant``
(``avenir_tpu_torch/models/discriminant.py``) and the native column parser
they read through, held against the JAX package's on the CPU.

``resource/fisher_discriminant/run.sh`` and the ``NumericalAttrStats`` leg
of ``resource/correlation_suite`` run through both command lines on the
same seeded churn rows.  The moments are host float64 NumPy sums over
the whole column and the text is Python's, so every comparison is byte
equality.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from avenir_tpu import native as jnative
from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import discriminant as jd

from avenir_tpu_torch import datagen, native
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import discriminant as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FISHER = os.path.join(REPO, "resource", "fisher_discriminant")
SUITE = os.path.join(REPO, "resource", "correlation_suite")


def _read(path) -> bytes:
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _runbooks(work, main, dg, extra=()):
    """The fisher_discriminant runbook and correlation_suite's
    NumericalAttrStats leg (both on telecom_churn 3000, seed 29)."""
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)

    def job(*argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(list(argv) + list(extra))
        assert rc in (0, None), err.getvalue()

    try:
        assert dg(["telecom_churn", "3000", "--seed", "29",
                   "--out", "work/in/part-00000"]) == 0
        job("FisherDiscriminant", f"-Dconf.path={FISHER}/fisher.properties",
            "work/in", "work/fisher")
        job("NumericalAttrStats", f"-Dconf.path={SUITE}/stats.properties",
            "work/in", "work/stats")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_discriminant")
    _runbooks(str(tmp / "jax"), jax_main, jax_datagen)
    _runbooks(str(tmp / "port"), port_main, datagen.main,
              extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("name", ["fisher", "stats"])
def test_runbooks_byte_identical(runbooks, name):
    got = _read(runbooks / "port" / "work" / name)
    assert got == _read(runbooks / "jax" / "work" / name)
    assert got


def test_fisher_needs_two_classes(tmp_path):
    rows = [f"r{i},{i},{'abc'[i % 3]}" for i in range(30)]
    (tmp_path / "in.csv").write_text("\n".join(rows) + "\n")
    cfg = {"attr.list": "1", "cond.attr.ord": "2"}
    with pytest.raises(ValueError, match="exactly 2 class values"):
        td.FisherDiscriminant(JobConfig(cfg), device="cpu").run(
            str(tmp_path / "in.csv"), str(tmp_path / "out"))
    with pytest.raises(ValueError, match="exactly 2 class values"):
        jd.FisherDiscriminant(JaxConfig(cfg)).run(
            str(tmp_path / "in.csv"), str(tmp_path / "jout"))


@pytest.mark.parametrize("cond", ["4", None])
def test_stats_unconditioned_and_conditioned_match_reference(tmp_path, cond):
    rng = np.random.default_rng(17)
    rows = [f"id{i},{rng.integers(-50, 50)},{rng.random() * 100:.6f},"
            f"{rng.integers(0, 9)},{'ABC'[int(rng.integers(3))]}"
            for i in range(500)]
    (tmp_path / "in.csv").write_text("\n".join(rows) + "\n")
    cfg = {"attr.list": "1,2,3"}
    if cond is not None:
        cfg["cond.attr.ord"] = cond
    td.NumericalAttrStats(JobConfig(cfg), device="cpu").run(
        str(tmp_path / "in.csv"), str(tmp_path / "port"))
    jd.NumericalAttrStats(JaxConfig(cfg)).run(
        str(tmp_path / "in.csv"), str(tmp_path / "jax"))
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")


def test_native_column_parser_matches_reference(tmp_path):
    """``parse_csv_columns`` (the binding of the C source's ``csv_parse``)
    returns the reference's typed columns, and None where the fast path
    does not apply."""
    rows = [f"id{i},{i * 7 - 300},{i / 3:.9g},{'xyz'[i % 3] * (i % 4 + 1)}"
            for i in range(257)]
    p = tmp_path / "in.csv"
    p.write_text("\n".join(rows) + "\n")
    types = [native.SKIP, native.INT64, native.FLOAT64, native.BYTES]
    got = native.parse_csv_columns(str(p), types)
    want = jnative.parse_csv_columns(str(p), types)
    assert got[0] == want[0] == 257
    assert sorted(got[1]) == sorted(want[1]) == [1, 2, 3]
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert native.parse_csv_columns(str(p), types, delim="::") is None
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("a,1,2.0,x\nb,2\n")
    assert native.parse_csv_columns(str(ragged), types) is None
    assert jnative.parse_csv_columns(str(ragged), types) is None
