"""The port's correlation jobs (``avenir_tpu_torch/models/correlation.py``)
held against the JAX package's on the CPU.

``resource/churn_cramer`` and the two correlation legs of
``resource/correlation_suite`` run through both command lines on the same
seeded churn rows; the job objects run side by side on the port's
8-position CPU mesh against the reference's ``mesh8``, under both
heterogeneity algorithms and from a stats file; the statistics are held
to the reference's on seeded tables.  The counts are integers and the
statistics host float64 NumPy, so every comparison is byte equality.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.datagen import gen_hosp_readmit, gen_telecom_churn
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import correlation as jc

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import correlation as tc
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAMER = os.path.join(REPO, "resource", "churn_cramer")
SUITE = os.path.join(REPO, "resource", "correlation_suite")
SCHEMA = os.path.join(CRAMER, "churn.json")
HOSP = os.path.join(REPO, "resource", "hosp_readmit_mi", "hosp_readmit.json")
CPU = torch.device("cpu")
OUTPUTS = ["cramer", "num", "het"]


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _runbooks(work, main, dg, extra=()):
    """The churn_cramer runbook and the correlation_suite's two
    correlation legs, with the working directory at their layout."""
    os.makedirs(work)
    shutil.copy(SCHEMA, work)
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
        job("CramerCorrelation", f"-Dconf.path={CRAMER}/cramer.properties",
            "work/in", "work/cramer")
        job("NumericalCorrelation",
            f"-Dconf.path={SUITE}/numerical.properties", "work/in",
            "work/num")
        job("HeterogeneityReductionCorrelation",
            f"-Dconf.path={SUITE}/hetero.properties", "work/in", "work/het")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_correlation")
    _runbooks(str(tmp / "jax"), jax_main, jax_datagen)
    _runbooks(str(tmp / "port"), port_main, datagen.main,
              extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("name", OUTPUTS)
def test_runbooks_byte_identical(runbooks, name):
    got = _read(runbooks / "port" / "work" / name)
    assert got == _read(runbooks / "jax" / "work" / name)
    assert got


# the hospital-readmission schema with its categoricals' cardinalities
# declared, for several attribute pairs
CARD = {4: ["employed", "unemployed", "retired"], 5: ["alone", "withPartner"],
        6: ["average", "poor", "good"], 11: ["N", "Y"]}


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_correlation_jobs")
    rows = [",".join(r) for r in gen_telecom_churn(1200, seed=29)]
    write_output(str(tmp / "in"), rows)
    with open(HOSP) as fh:
        schema = json.load(fh)
    for f in schema["fields"]:
        if f["ordinal"] in CARD:
            f["cardinality"] = CARD[f["ordinal"]]
    (tmp / "hosp.json").write_text(json.dumps(schema))
    rows = [",".join(r) for r in gen_hosp_readmit(1500, seed=13)]
    write_output(str(tmp / "hosp"), rows)
    return tmp


@pytest.mark.parametrize("job,over", [
    ("CramerCorrelation", {}),
    ("HeterogeneityReductionCorrelation", {}),
    ("HeterogeneityReductionCorrelation",
     {"heterogeneity.algorithm": "uncertainty"}),
], ids=["cramer", "gini", "uncertainty"])
def test_pairs_on_a_mesh_match_reference(churn, mesh8, job, over):
    """Five pairs of four attributes (a self pair dropped), on the port's
    4 x 2 CPU mesh and on one device, against the reference on mesh8."""
    props = {"feature.schema.file.path": str(churn / "hosp.json"),
             "source.attributes": "4,5,6", "dest.attributes": "11,4"}
    props.update(over)
    tag = f"{job}{len(over)}"
    getattr(jc, job)(JaxConfig(dict(props))).run(
        str(churn / "hosp"), str(churn / f"{tag}_jax"), mesh=mesh8)
    want = _read(churn / f"{tag}_jax")
    assert len(want.splitlines()) == 5
    for name, m in (("one", None),
                    ("mesh", pmesh.make_mesh([CPU] * 8, data=4, model=2))):
        counters = getattr(tc, job)(JobConfig(dict(props)), device="cpu").run(
            str(churn / "hosp"), str(churn / f"{tag}_{name}"), mesh=m)
        assert _read(churn / f"{tag}_{name}") == want, name
        assert counters.get("Correlation", "Pairs") == 5


def test_numerical_correlation_from_a_stats_file(churn):
    """``stats.file.path`` in the stats job's layout (attr, cond, sum,
    sumSq, count, mean, variance, stdDev): both packages read the same
    means and deviations."""
    stats = churn / "stats.txt"
    stats.write_text("2,0,1.0,1.0,3,600.5,100.0,40.25\n"
                     "3,0,1.0,1.0,3,250.0,9.0,60.5\n"
                     "6,0,1.0,1.0,3,4.0,1.0,1.5\n")
    props = {"nco.attr.pairs": "2:3,2:6;3:6",
             "nco.stats.file.path": str(stats)}
    jc.NumericalCorrelation(JaxConfig(dict(props))).run(
        str(churn / "in"), str(churn / "nstats_jax"))
    tc.NumericalCorrelation(JobConfig(dict(props)), device="cpu").run(
        str(churn / "in"), str(churn / "nstats_port"))
    assert _read(churn / "nstats_port") == _read(churn / "nstats_jax")
    mgr = tc.NumericalAttrStatsManager(str(stats))
    ref = jc.NumericalAttrStatsManager(str(stats))
    for attr in (2, 3, 6):
        assert (mgr.mean(attr), mgr.variance(attr), mgr.std_dev(attr),
                mgr.count(attr)) == (ref.mean(attr), ref.variance(attr),
                                     ref.std_dev(attr), ref.count(attr))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_statistics_match_reference(seed):
    """Seeded contingency tables, some with empty rows and columns."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 50, (2 + seed, 3 + seed % 2))
    if seed % 2:
        t[0] = 0
        t[:, -1] = 0
    for fn in ("cramer_index", "concentration_coeff", "uncertainty_coeff"):
        with np.errstate(all="ignore"):
            want = getattr(jc, fn)(t)
            got = getattr(tc, fn)(t)
        assert repr(got) == repr(want), fn


def test_undeclared_value_raises_like_reference(tmp_path):
    rows = [",".join(r) for r in gen_telecom_churn(50, seed=3)]
    f = rows[7].split(",")
    f[1] = "planQ"
    write_output(str(tmp_path / "in"), rows + [",".join(f)])
    props = {"feature.schema.file.path": SCHEMA, "source.attributes": "1",
             "dest.attributes": "7"}
    with pytest.raises(KeyError, match="planQ"):
        jc.CramerCorrelation(JaxConfig(dict(props))).run(
            str(tmp_path / "in"), str(tmp_path / "j"))
    with pytest.raises(KeyError, match="planQ"):
        tc.CramerCorrelation(JobConfig(dict(props)), device="cpu").run(
            str(tmp_path / "in"), str(tmp_path / "p"))


def test_cat_corr_local_matches_reference_with_mask():
    rng = np.random.default_rng(9)
    n, P, K = 500, 3, 4
    src = rng.integers(-1, K + 1, (n, P)).astype(np.int32)
    dst = rng.integers(-1, K + 1, (n, P)).astype(np.int32)
    mask = rng.random(n) < 0.6
    want = np.asarray(jc._cat_corr_local(src, dst, mask, (P, K, K)))
    got = tc._cat_corr_local(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(mask), (P, K, K))
    np.testing.assert_array_equal(got.numpy(), want)
