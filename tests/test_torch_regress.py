"""The port's logistic regression (``avenir_tpu_torch/models/regress.py``)
held against the JAX package's on the CPU.

``resource/logistic_regression``'s loop runs through both command lines
(each iteration a job whose exit status is 100 converged or 101 not yet)
on the rows of its ``gen.py``: both must converge at the same iteration
with coefficient histories of the same length, equal within ``rtol=1e-9``
(the tolerance the reference's own tests hold it to against a NumPy
oracle: the port's float64 products sum in another order).  The history
is carried across packages both ways, and the job runs on the port's CPU
mesh against the reference's ``mesh8`` under every convergence criterion.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.models import regress as jr

from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import regress as tr
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK = os.path.join(REPO, "resource", "logistic_regression")
CPU = torch.device("cpu")
RTOL = 1e-9


def _history(path):
    with open(path) as fh:
        return [[float(v) for v in line.split(",")]
                for line in fh.read().splitlines()]


def _loop(work, main, extra=(), limit=60):
    """run.sh's loop: returns (iterations, last exit status)."""
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for it in range(1, limit + 1):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = main(["LogisticRegressionJob",
                           f"-Dconf.path={BOOK}/lr.properties", "work/in",
                           "work/out", *extra])
            assert rc in (jr.CONVERGED, jr.NOT_CONVERGED), err.getvalue()
            if rc == jr.CONVERGED:
                return it, rc
        return limit, rc
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runbook(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_regress")
    rows = subprocess.run([sys.executable, os.path.join(BOOK, "gen.py"),
                           "2000"], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for name, main, extra in (("jax", jax_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        work = tmp / name
        os.makedirs(work / "work" / "in")
        (work / "lr.json").write_text((open(os.path.join(BOOK, "lr.json"))
                                       .read()))
        (work / "work" / "in" / "part-00000").write_text(rows)
        (work / "work" / "coeff.txt").write_text("0.0,0.0,0.0,0.0,0.0\n")
        out[name] = _loop(str(work), main, extra)
    return tmp, out


def test_runbook_converges_at_the_same_iteration(runbook):
    tmp, out = runbook
    assert out["port"] == out["jax"]
    assert out["jax"][1] == jr.CONVERGED and 2 < out["jax"][0] < 60
    got = _history(tmp / "port" / "work" / "coeff.txt")
    want = _history(tmp / "jax" / "work" / "coeff.txt")
    assert len(got) == len(want) == out["jax"][0] + 1
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with open(tmp / "port" / "work" / "out" / "part-r-00000") as fh:
        last = [float(v) for v in fh.read().split(",")]
    np.testing.assert_allclose(last, want[-1], rtol=RTOL)


SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "f1", "ordinal": 1, "dataType": "int", "feature": True},
    {"name": "f2", "ordinal": 2, "dataType": "int", "feature": True},
    {"name": "f3", "ordinal": 3, "dataType": "int", "feature": True},
    {"name": "cls", "ordinal": 4, "dataType": "categorical"}]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """37 rows (8 does not divide them) of three int features."""
    tmp = tmp_path_factory.mktemp("torch_regress_data")
    rng = np.random.default_rng(7)
    n = 37
    feats = rng.integers(-5, 6, (n, 3))
    y = (feats @ [0.8, -0.5, 0.3] + rng.normal(0, 1, n)) > 0
    write_output(str(tmp / "in"), [
        f"r{i},{feats[i, 0]},{feats[i, 1]},{feats[i, 2]},"
        f"{'Y' if y[i] else 'N'}" for i in range(n)])
    (tmp / "schema.json").write_text(json.dumps(SCHEMA))
    return tmp


def _props(tmp, coeff, **over):
    props = {"feature.schema.file.path": str(tmp / "schema.json"),
             "coeff.file.path": str(coeff), "positive.class.value": "Y"}
    props.update(over)
    return props


@pytest.mark.parametrize("over", [
    {"learning.rate": "0.5", "convergence.criteria": "allBelowThreshold",
     "convergence.threshold": "1"},
    {"learning.rate": "0.2", "convergence.criteria": "averageBelowThreshold",
     "convergence.threshold": "0.5"},
    {"convergence.criteria": "iterLimit", "iteration.limit": "6"},
    {"convergence.criteria": "averageBelowThreshold"},     # fixed point
], ids=["all-lr", "average-lr", "iterLimit", "fixed-point"])
def test_run_loop_matches_reference_on_a_mesh(data, mesh8, over):
    start = "0.1,-0.2,0.3,0.0\n"
    (data / "cj.txt").write_text(start)
    jstatus = jr.LogisticRegressionJob(JaxConfig(_props(
        data, data / "cj.txt", **over))).run_loop(
        str(data / "in"), str(data / "jo"), max_iterations=40)
    want = _history(data / "cj.txt")
    for name, m in (("one", None),
                    ("mesh", pmesh.make_mesh([CPU] * 8, data=4, model=2))):
        coeff = data / f"c{name}.txt"
        coeff.write_text(start)
        job = tr.LogisticRegressionJob(JobConfig(_props(data, coeff, **over)),
                                       device="cpu")
        status = tr.NOT_CONVERGED
        for _ in range(40):
            status = job.run(str(data / "in"), str(data / name), mesh=m)
            if status != tr.NOT_CONVERGED:
                break
        assert status == jstatus, name
        got = _history(coeff)
        assert len(got) == len(want), name
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert job.counters.get("Regression", "Iterations") == len(want) - 1


@pytest.mark.parametrize("begun_by", ["jax", "port"])
def test_history_carried_across_packages(data, begun_by):
    """Three iterations by one package, three more by the other, against
    six by the reference alone."""
    over = {"learning.rate": "0.3", "iteration.limit": "99"}
    ref = data / f"ref{begun_by}.txt"
    ref.write_text("0.0,0.0,0.0,0.0\n")
    rjob = jr.LogisticRegressionJob(JaxConfig(_props(data, ref, **over)))
    for _ in range(6):
        rjob.run(str(data / "in"), str(data / "rout"))
    coeff = data / f"carry{begun_by}.txt"
    coeff.write_text("0.0,0.0,0.0,0.0\n")
    jjob = jr.LogisticRegressionJob(JaxConfig(_props(data, coeff, **over)))
    pjob = tr.LogisticRegressionJob(JobConfig(_props(data, coeff, **over)),
                                    device="cpu")
    first, second = (jjob, pjob) if begun_by == "jax" else (pjob, jjob)
    for job in (first, second):
        for _ in range(3):
            job.run(str(data / "in"), str(data / "cout"))
    np.testing.assert_allclose(_history(coeff), _history(ref), rtol=RTOL)


def test_gradient_matches_numpy_oracle(data):
    """One fixed-point step: the aggregate ``x^T (y - sigmoid(x w))``."""
    rows = [line.split(",") for line in
            (data / "in" / "part-r-00000").read_text().splitlines()]
    x = np.asarray([[1.0] + [float(v) for v in r[1:4]] for r in rows])
    y = np.asarray([1.0 if r[4] == "Y" else 0.0 for r in rows])
    w = np.asarray([0.1, -0.2, 0.3, 0.05])
    coeff = data / "oracle.txt"
    coeff.write_text(",".join(repr(float(v)) for v in w) + "\n")
    tr.LogisticRegressionJob(JobConfig(_props(data, coeff)),
                             device="cpu").run(str(data / "in"),
                                               str(data / "oout"))
    want = x.T @ (y - 1.0 / (1.0 + np.exp(-(x @ w))))
    np.testing.assert_allclose(_history(coeff)[-1], want, rtol=RTOL)


def test_convergence_math_matches_reference():
    prev = np.asarray([0.0, 1.0, -2.0, 4.0])
    for cur in ([0.0, 1.01, -2.03, 4.0], [1.0, 1.0, -2.0, 4.0],
                [0.0, 2.0, -1.0, 0.0]):
        a = tr.LogisticRegressor(prev, cur)
        b = jr.LogisticRegressor(prev, cur)
        np.testing.assert_array_equal(a.coeff_diff(), b.coeff_diff())
        for t in (0.5, 2.0, 60.0):
            assert a.is_all_converged(t) == b.is_all_converged(t)
            assert a.is_average_converged(t) == b.is_average_converged(t)


def test_coefficient_width_and_empty_history_are_refused(data):
    coeff = data / "bad.txt"
    coeff.write_text("0.0,0.0\n")
    job = tr.LogisticRegressionJob(JobConfig(_props(data, coeff)),
                                   device="cpu")
    with pytest.raises(ValueError, match="expected 4"):
        job.run(str(data / "in"), str(data / "bad"))
    coeff.write_text("")
    with pytest.raises(ValueError, match="initial coefficient line"):
        job.run(str(data / "in"), str(data / "bad"))


def test_cli_exit_status_is_the_jobs(data):
    coeff = data / "cli.txt"
    coeff.write_text("0.0,0.0,0.0,0.0\n")
    argv = ["LogisticRegressionJob",
            f"-Dfeature.schema.file.path={data / 'schema.json'}",
            f"-Dcoeff.file.path={coeff}", "-Dpositive.class.value=Y",
            "-Diteration.limit=3", str(data / "in"), str(data / "cli"),
            "--device", "cpu"]
    codes = {}
    for name, main, extra in (("jax", jax_main, 0), ("port", port_main, 2)):
        coeff.write_text("0.0,0.0,0.0,0.0\n")
        codes[name] = []
        for _ in range(3):
            with contextlib.redirect_stderr(io.StringIO()):
                codes[name].append(main(argv[:len(argv) - 2 + extra]))
    # iterLimit: converged once the history holds ``iteration.limit`` lines
    assert codes["port"] == codes["jax"] == [
        tr.NOT_CONVERGED, tr.CONVERGED, tr.CONVERGED]
