"""The PyTorch port's Naive Bayes train -> batch score held against the JAX
package, on the CPU.

Inputs: the churn runbook's data (resource/churn_nb/run.sh: 3000 rows,
seed 29, 2400 train / 600 test) and seeded synthetic scoring tables.
Model files and float64 predictions must be byte-identical; the float32
scorer must keep the reference's own float32-vs-float64 contract
(``BayesianPredictor.f32_score_parity_violations``) with zero violations.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.datagen import gen_telecom_churn as jax_gen_churn
from avenir_tpu.models import bayesian as jb

from avenir_tpu_torch import convert, datagen
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.models import bayesian as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNBOOK = os.path.join(REPO, "resource", "churn_nb")
SCHEMA = os.path.join(RUNBOOK, "teleComChurn.json")
CPU = torch.device("cpu")
LN_HEALTHY_IEEE = np.log(1e-250)


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def runbook(tmp_path_factory):
    """The runbook's data, written by the port's generator, and the
    reference's model trained on it."""
    d = tmp_path_factory.mktemp("churn_nb")
    os.makedirs(d / "train")
    os.makedirs(d / "test")
    assert datagen.main(["telecom_churn", "3000", "--seed", "29",
                         "--out", str(d / "all.csv")]) == 0
    with open(d / "all.csv") as fh:
        lines = fh.read().splitlines(keepends=True)
    with open(d / "train" / "part-00000", "w") as fh:
        fh.writelines(lines[:2400])
    with open(d / "test" / "part-00000", "w") as fh:
        fh.writelines(lines[2400:])
    jb.BayesianDistribution(JaxConfig(
        {"feature.schema.file.path": SCHEMA})).run(str(d / "train"),
                                                   str(d / "model_jax"))
    return d


def test_datagen_matches_reference(runbook):
    rows = jax_gen_churn(3000, seed=29)
    with open(runbook / "all.csv") as fh:
        assert fh.read() == "\n".join(",".join(r) for r in rows) + "\n"
    assert datagen.gen_telecom_churn(50, seed=2) == jax_gen_churn(50, seed=2)


@pytest.mark.parametrize("props", [
    pytest.param({"pipeline.chunk.rows": "512"}, id="streamed-512-row-chunks"),
    pytest.param({"pipeline.chunk.rows": "512",
                  "pipeline.prefetch.depth": "0"}, id="streamed-serial"),
    pytest.param({}, id="streamed-byte-chunks"),
    pytest.param({"ingest.chunk.bytes": "20000"}, id="streamed-small-bytes"),
])
def test_trainer_model_byte_identical(runbook, tmp_path, props):
    cfg = dict(props, **{"feature.schema.file.path": SCHEMA})
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jc = jb.BayesianDistribution(JaxConfig(dict(cfg))).run(
        str(runbook / "train"), str(jax_out))
    pc = tb.BayesianDistribution(JobConfig(dict(cfg)), device="cpu").run(
        str(runbook / "train"), str(port_out))
    assert _read(port_out) == _read(jax_out)
    assert pc.as_dict() == jc.as_dict()
    if "pipeline.chunk.rows" in props:
        assert pc.get("Ingest", "Chunks") == 5      # 2400 rows / 512


def test_trainer_monolithic_lines_identical(runbook):
    """``train_lines`` on one encoded dataset (the one-shot path)."""
    from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
    from avenir_tpu_torch.core.binning import DatasetEncoder

    train = str(runbook / "train")
    jjob = jb.BayesianDistribution(JaxConfig({"feature.schema.file.path": SCHEMA}))
    pjob = tb.BayesianDistribution(JobConfig({"feature.schema.file.path": SCHEMA}),
                                   device="cpu")
    want = jjob.train_lines(JaxEncoder(jjob.schema).encode_path(train), ",",
                            JaxCounters())
    ds = DatasetEncoder(pjob.schema).encode_path(train)
    np.testing.assert_array_equal(
        ds.x, JaxEncoder(jjob.schema).encode_path(train).x)
    assert pjob.train_lines(ds, ",", Counters()) == want
    with open(os.path.join(runbook / "model_jax", "part-r-00000")) as fh:
        assert fh.read().splitlines() == want


def test_trainer_falls_back_on_late_category(tmp_path):
    """A class value first seen after chunk 0 overflows the streamed
    trainer's class cap; the one-shot fallback must still give the
    reference's bytes."""
    rows = jax_gen_churn(600, seed=3)
    rows = [r for r in rows if r[-1] == "N"][:300] + \
        [r for r in rows if r[-1] == "Y"][:60]
    with open(tmp_path / "in.csv", "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")
    schema = tmp_path / "schema.json"
    with open(SCHEMA) as fh:
        text = fh.read()
    with open(schema, "w") as fh:       # no declared class cardinality
        fh.write(text.replace(',\n   "cardinality": ["N", "Y"]', ""))
    cfg = {"feature.schema.file.path": str(schema),
           "pipeline.chunk.rows": "100"}
    jb.BayesianDistribution(JaxConfig(dict(cfg))).run(
        str(tmp_path / "in.csv"), str(tmp_path / "jax"))
    c = tb.BayesianDistribution(JobConfig(dict(cfg)), device="cpu").run(
        str(tmp_path / "in.csv"), str(tmp_path / "port"))
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    assert c.get("Ingest", "Chunks") == 0       # the fallback ran


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_predictor_runbook_outputs(runbook, tmp_path, precision):
    """Prediction files through both packages: float64 byte-identical;
    float32 within the reference's parity contract (against the
    reference's float64 probabilities)."""
    cfg = {"feature.schema.file.path": SCHEMA,
           "bayesian.model.file.path": str(runbook / "model_jax"),
           "bp.score.precision": precision}
    jjob = jb.BayesianPredictor(JaxConfig(dict(cfg), "bp"))
    pjob = tb.BayesianPredictor(JobConfig(dict(cfg), "bp"), device="cpu")
    jc = jjob.run(str(runbook / "test"), str(tmp_path / "jax"))
    pc = pjob.run(str(runbook / "test"), str(tmp_path / "port"))
    lines = list(tb.read_lines(str(runbook / "test")))
    records = [l.split(",") for l in lines]
    ds, tables, probs, _, _ = pjob.score(records)
    if precision == "float64":
        assert _read(tmp_path / "port") == _read(tmp_path / "jax")
        assert pc.as_dict() == jc.as_dict()
        return
    p64 = np.asarray(jb.BayesianPredictor._score_batch(
        *map(jnp.asarray, (ds.x, ds.values) + tuple(tables)))[0])
    post, prior, gpost, gprior, class_prior, is_cont = tables
    lfp, lfpo = jb.BayesianPredictor.log_oracle(ds.x, ds.values, post, prior,
                                                gpost, gprior, is_cont)
    viol = jb.BayesianPredictor.f32_score_parity_violations(
        p64, probs, lfp, lfpo, class_prior, ln_healthy=LN_HEALTHY_IEEE)
    assert viol["healthy"] == 0 and viol["tail"] == 0, viol
    assert viol["n_healthy"] > 0


def _tables_case(kind, F=24, C=2, n_cont=3):
    """(x, values, post, prior, gauss_post, gauss_prior, class_prior,
    is_cont) for the scoring cases; ``tails`` at ``F`` features, ``C``
    classes and ``n_cont`` Gaussian columns."""
    rng = np.random.default_rng({"tails": 17, "unseen": 5}[kind])
    if kind == "tails":
        # posteriors log-uniform over [1e-4, 1) and Gaussian columns deep
        # in the tail: products far outside f32
        n, B = 512, 10
        x = rng.integers(0, B, (n, F)).astype(np.int32)
        values = rng.uniform(0, 100, (n, F))
        post = 10.0 ** rng.uniform(-4, 0, (C, F, B))
        prior = 10.0 ** rng.uniform(-4, 0, (F, B))
        gauss_post = np.stack([rng.uniform(10, 50, (C, F)),
                               rng.uniform(1, 8, (C, F))], -1)
        gauss_prior = np.stack([rng.uniform(10, 50, F),
                                rng.uniform(1, 8, F)], -1)
        class_prior = np.asarray({2: [0.9, 0.1], 3: [0.85, 0.1, 0.05]}[C])
        is_cont = np.arange(F) >= F - n_cont
    else:
        # a bin never observed in training: zero posterior and prior
        n, F, C, B = 64, 4, 2, 6
        x = rng.integers(0, B - 1, (n, F)).astype(np.int32)
        x[0, 1] = B - 1
        values = rng.uniform(0, 10, (n, F))
        post = rng.uniform(0.1, 1.0, (C, F, B))
        post[:, 1, B - 1] = 0.0
        prior = rng.uniform(0.1, 1.0, (F, B))
        prior[1, B - 1] = 0.0
        gauss_post = np.stack([rng.uniform(5, 9, (C, F)),
                               rng.uniform(1, 2, (C, F))], -1)
        gauss_prior = np.stack([rng.uniform(5, 9, F),
                                rng.uniform(1, 2, F)], -1)
        class_prior = np.asarray([0.5, 0.5])
        is_cont = np.zeros(F, bool)
    return x, values, post, prior, gauss_post, gauss_prior, class_prior, is_cont


@pytest.mark.parametrize("kind", ["tails", "unseen", "runbook"])
def test_score_batch_matches_reference(runbook, kind):
    """The reference's tables go through ``convert``; the port's float64
    scorer gives the reference's exact int probabilities, and its float32
    scorer keeps the reference's parity contract."""
    if kind == "runbook":
        cfg = {"feature.schema.file.path": SCHEMA,
               "bayesian.model.file.path": str(runbook / "model_jax")}
        jjob = jb.BayesianPredictor(JaxConfig(cfg, "bp"))
        from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
        ds = JaxEncoder(jjob.schema).encode_path(str(runbook / "test"))
        x, values = ds.x, ds.values
        tables = jjob._build_tables(ds)
    else:
        x, values, *tables = _tables_case(kind)
    j64, jprior, jpost = jb.BayesianPredictor._score_batch(
        *map(jnp.asarray, [x, values] + list(tables)))
    args = (torch.from_numpy(x), torch.from_numpy(values)) + \
        convert.predictor_tables_to_device(tables, CPU)
    p64, pprior, ppost = tb.BayesianPredictor._score_batch(*args)
    np.testing.assert_array_equal(p64.numpy(), np.asarray(j64))
    # feature probabilities: the same float64 products in the same order,
    # with the port's bit-exact copy of XLA's float64 exp (ops.xla_math)
    np.testing.assert_array_equal(pprior.numpy(), np.asarray(jprior))
    np.testing.assert_array_equal(ppost.numpy(), np.asarray(jpost))

    p32, fprior32, fpost32 = tb.BayesianPredictor._score_batch_f32(*args)
    post, prior, gpost, gprior, class_prior, is_cont = tables
    lfp, lfpo = jb.BayesianPredictor.log_oracle(x, values, post, prior,
                                                gpost, gprior, is_cont)
    viol = jb.BayesianPredictor.f32_score_parity_violations(
        np.asarray(j64), p32.numpy(), lfp, lfpo, class_prior,
        ln_healthy=LN_HEALTHY_IEEE)
    assert viol["healthy"] == 0 and viol["tail"] == 0, viol
    assert viol["n_healthy"] > 0
    # the port's own copy of the checker and oracle agree with the reference
    assert tb.BayesianPredictor.f32_score_parity_violations(
        np.asarray(j64), p32.numpy(), lfp, lfpo, class_prior,
        ln_healthy=LN_HEALTHY_IEEE) == viol
    for a, b in zip(tb.BayesianPredictor.log_oracle(
            x, values, post, prior, gpost, gprior, is_cont), (lfp, lfpo)):
        np.testing.assert_array_equal(a, b)
    if kind == "unseen":
        assert (p32.numpy()[0] == 0).all() and (p64.numpy()[0] == 0).all()
        assert fprior32.numpy()[0] == 0.0 and (fpost32.numpy()[0] == 0).all()


@pytest.mark.parametrize("vals", [
    pytest.param(np.array([np.nan, 1e300, -1e300, 12.9, -12.9, 2147483647.5,
                           -2147483648.0]), id="float64"),
    pytest.param(np.array([np.nan, 3e38, -3e38, 12.9, -12.9, 2147483520.0,
                           2147483648.0], np.float32), id="float32"),
])
def test_java_int32_matches_reference(vals):
    want = np.asarray(jb._java_int32(jnp.asarray(vals)))
    np.testing.assert_array_equal(tb._java_int32(torch.from_numpy(vals)).numpy(),
                                  want)
    if vals.dtype == np.float64:
        np.testing.assert_array_equal(tb._java_int32_np(vals),
                                      jb._java_int32_np(vals))


@pytest.mark.parametrize("a,b,vsq,cnt,mean", [
    (7, 2, 10, 1, 3), (-7, 2, 50, 4, -3), (7, -2, 0, 3, 5), (-9, -4, 99, 9, 2),
])
def test_java_arithmetic_matches_reference(a, b, vsq, cnt, mean):
    assert tb._jdiv(a, b) == jb._jdiv(a, b)
    assert tb._jstd(vsq, cnt, mean) == jb._jstd(vsq, cnt, mean)


def test_host_moments_match_reference():
    rng = np.random.default_rng(4)
    values = rng.integers(0, 30, (1000, 4)).astype(np.float64)
    y = rng.integers(0, 3, 1000).astype(np.int32)
    want = jb._host_moments(values, y, 3, [1, 3])
    got = tb._host_moments(values, y, 3, [1, 3])
    assert got.keys() == want.keys()
    for j in want:
        np.testing.assert_array_equal(got[j], want[j])


def test_cli_runbook_cpu(runbook, tmp_path):
    """``python -m avenir_tpu_torch ... --device cpu``, the runbook's two
    commands: the same model and float64 predictions as the reference."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    nb = os.path.join(RUNBOOK, "nb.properties")
    bp = os.path.join(RUNBOOK, "bp.properties")
    shutil.copy(SCHEMA, tmp_path / "teleComChurn.json")
    run = subprocess.run(
        [sys.executable, "-c",
         "import sys; from avenir_tpu_torch.cli import main; "
         "sys.exit(main(sys.argv[1:6]) or main(sys.argv[6:]))",
         "BayesianDistribution", f"-Dconf.path={nb}", str(runbook / "train"),
         "model", "--device=cpu",
         "org.avenir.bayesian.BayesianPredictor", f"-Dconf.path={bp}",
         "-Dbayesian.model.file.path=model", "-Dbp.score.precision=float64",
         str(runbook / "test"), "pred",
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "Ingest\tChunks\t1" in run.stderr
    assert "Validation\tCorrect" in run.stderr
    assert _read(tmp_path / "model") == _read(runbook / "model_jax")
    want = tmp_path / "pred_jax"
    jb.BayesianPredictor(JaxConfig(
        {"feature.schema.file.path": SCHEMA,
         "bayesian.model.file.path": str(runbook / "model_jax"),
         "bp.score.precision": "float64"}, "bp")).run(str(runbook / "test"),
                                                      str(want))
    assert _read(tmp_path / "pred") == _read(want)


# ---------------------------------------------------------------------------
# XLA's float math: the feature probabilities printed by prob-only mode
# ---------------------------------------------------------------------------

def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    same = got.view(np.uint8).reshape(got.shape + (-1,)) == \
        want.view(np.uint8).reshape(want.shape + (-1,))
    return same.all(-1) | (np.isnan(got) & np.isnan(want))


def test_exp_f64_matches_xla_bit_for_bit():
    """1.2M seeded inputs over the whole finite range, and the edges."""
    import jax

    from avenir_tpu_torch.ops import xla_math

    rng = np.random.default_rng(7)
    lo, hi = xla_math._LO, xla_math._HI
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-300,
             -745.2, 709.9]
    for v in (lo, hi):
        edges += [v, np.nextafter(v, -np.inf), np.nextafter(v, np.inf)]
    x = np.concatenate([rng.uniform(-745, 709, 1_000_000),
                        rng.uniform(-50, 5, 200_000), edges])
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = xla_math.exp_f64(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, want).all()
    with np.errstate(over="ignore"):
        assert not _bits_equal(np.exp(x), want).all()  # libm is not XLA's


def test_log_f32_and_fma_f32_match_xla_bit_for_bit():
    import jax

    from avenir_tpu_torch.ops import xla_math

    rng = np.random.default_rng(8)
    x = np.concatenate([
        (10.0 ** rng.uniform(-45, 38.5, 500_000)).astype(np.float32),
        rng.uniform(0.4, 1.6, 200_000).astype(np.float32),
        np.float32([0, -0.0, np.inf, -np.inf, np.nan, -1, 1e-45, 1e-40,
                    1.17549435e-38, 1, 2, 0.5, 3.4e38])])
    want = np.asarray(jax.jit(jnp.log)(x))
    assert _bits_equal(xla_math.log_f32(torch.from_numpy(x)).numpy(),
                       want).all()
    # XLA's backend contracts a*b+c into one FMA
    a, b, c = (rng.standard_normal(300_000).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = xla_math.fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    assert _bits_equal(got, want).all()


@pytest.mark.parametrize("F,n_cont", [(2, 2), (6, 1), (13, 13)])
def test_f32_feature_probabilities_match_reference(F, n_cont):
    """The float32 scorer's float64 feature probabilities are the
    reference's bits on rows XLA sums left to right (up to 15 features;
    wider rows: ``test_f32_wide_row_sums_match_reference``)."""
    rng = np.random.default_rng(F)
    n, C, B = 3000, 2, 7
    x = rng.integers(0, B, (n, F)).astype(np.int32)
    values = rng.uniform(-20, 120, (n, F))
    post = 10.0 ** rng.uniform(-4, 0, (C, F, B))
    prior = 10.0 ** rng.uniform(-4, 0, (F, B))
    gpost = np.stack([rng.integers(0, 60, (C, F)).astype(float),
                      rng.integers(0, 9, (C, F)).astype(float)], -1)
    gprior = np.stack([rng.integers(0, 60, F).astype(float),
                       rng.integers(0, 9, F).astype(float)], -1)
    tables = (post, prior, gpost, gprior, rng.dirichlet(np.ones(C)),
              np.arange(F) < n_cont)
    _, jprior, jpost = jax.jit(jb.BayesianPredictor._score_batch_f32)(
        *map(jnp.asarray, (x, values) + tables))
    _, pprior, ppost = tb.BayesianPredictor._score_batch_f32(
        torch.from_numpy(x), torch.from_numpy(values),
        *convert.predictor_tables_to_device(tables, CPU))
    np.testing.assert_array_equal(pprior.numpy(), np.asarray(jprior))
    np.testing.assert_array_equal(ppost.numpy(), np.asarray(jpost))


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("n_cont", [0, 3], ids=["discrete", "gaussian"])
@pytest.mark.parametrize("F", [14, 16, 17, 20, 23, 24, 31, 32, 33, 40, 48])
def test_f32_wide_row_sums_match_reference(F, n_cont, C):
    """The float32 scorer's feature probabilities on the ``tails`` tables
    are the reference's bits at widths where XLA vectorizes the row's
    log-sum (16-32 columns) or splits it into 32-wide windows (33 and
    up): ``models.bayesian._sum_last`` follows that order."""
    x, values, *tables = _tables_case("tails", F=F, C=C, n_cont=n_cont)
    _, jprior, jpost = jax.jit(jb.BayesianPredictor._score_batch_f32)(
        *map(jnp.asarray, [x, values] + tables))
    _, pprior, ppost = tb.BayesianPredictor._score_batch_f32(
        torch.from_numpy(x), torch.from_numpy(values),
        *convert.predictor_tables_to_device(tables, CPU))
    assert ppost.shape == (x.shape[0], C)
    assert _bits_equal(pprior.numpy(), np.asarray(jprior)).all()
    assert _bits_equal(ppost.numpy(), np.asarray(jpost)).all()


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_prob_only_output_byte_identical(runbook, tmp_path, precision):
    """``output.feature.prob.only`` prints the raw float64 feature
    probabilities: the same bytes as the reference, on the churn runbook
    (one Gaussian column) and on the kNN runbook's blobs (two)."""
    blobs = str(tmp_path / "blobs")
    os.makedirs(blobs)
    with open(os.path.join(blobs, "part-00000"), "w") as fh:
        fh.write("\n".join(",".join(r)
                           for r in datagen.gen_blobs(400, seed=5)) + "\n")
    blobs_schema = os.path.join(REPO, "resource", "knn_classify",
                                "blobs.json")
    jb.BayesianDistribution(JaxConfig({
        "feature.schema.file.path": blobs_schema})).run(
        blobs, str(tmp_path / "blobs_model"))
    for schema, model, data in (
            (SCHEMA, str(runbook / "model_jax"), str(runbook / "test")),
            (blobs_schema, str(tmp_path / "blobs_model"), blobs)):
        cfg = {"feature.schema.file.path": schema,
               "bayesian.model.file.path": model,
               "output.feature.prob.only": "true",
               "bp.score.precision": precision}
        jb.BayesianPredictor(JaxConfig(dict(cfg), "bp")).run(
            data, str(tmp_path / "jax"))
        tb.BayesianPredictor(JobConfig(dict(cfg), "bp"), device="cpu").run(
            data, str(tmp_path / "port"))
        assert _read(tmp_path / "port") == _read(tmp_path / "jax"), schema


# ---------------------------------------------------------------------------
# drift gauges (telemetry.drift.baseline.path)
# ---------------------------------------------------------------------------

def _drift_run(pkg, cfg_cls, runbook, out, baseline):
    from avenir_tpu.core import telemetry as jtel
    from avenir_tpu_torch.core import telemetry as ttel
    cfg = cfg_cls({"feature.schema.file.path": SCHEMA,
                   "telemetry.drift.baseline.path": baseline})
    if pkg is jb:
        counters = jb.BayesianDistribution(cfg).run(str(runbook / "train"),
                                                    out)
        gauges = jtel.get_metrics().snapshot()["gauges"]
    else:
        counters = tb.BayesianDistribution(cfg, device="cpu").run(
            str(runbook / "train"), out)
        gauges = ttel.get_metrics().snapshot()["gauges"]
    drift = {k: v for k, v in gauges.items() if k.startswith("drift.")}
    return counters.as_dict().get("Drift", {}), drift


@pytest.fixture(scope="module")
def other_baseline(tmp_path_factory):
    """A model trained on other rows (seed 30), so the gauges move."""
    d = tmp_path_factory.mktemp("drift_baseline")
    rows = jax_gen_churn(1200, seed=30)
    os.makedirs(d / "train")
    with open(d / "train" / "part-00000", "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")
    jb.BayesianDistribution(JaxConfig(
        {"feature.schema.file.path": SCHEMA})).run(str(d / "train"),
                                                   str(d / "model"))
    return str(d / "model")


@pytest.mark.parametrize("which", ["first-model", "other-rows"])
def test_drift_counters_match_reference(runbook, tmp_path, other_baseline,
                                        which):
    """The re-anchor's reproduction: train the runbook's 2,400 rows, then
    train them again against a stored baseline.  The port prints the
    reference's ``Drift`` counters value for value, sets the same
    ``drift.<feature>`` gauges, and writes the same model bytes."""
    baseline = (str(runbook / "model_jax") if which == "first-model"
                else other_baseline)
    ref_counters, ref_gauges = _drift_run(
        jb, JaxConfig, runbook, str(tmp_path / "ref"), baseline)
    counters, gauges = _drift_run(
        tb, JobConfig, runbook, str(tmp_path / "port"), baseline)
    names = ["plan", "minUsed", "dataUsed", "csCall", "csEmail"]
    assert sorted(counters) == sorted(f"{n} (KL x1e6)" for n in names)
    assert counters == ref_counters
    assert {k: v["value"] for k, v in gauges.items()} \
        == {k: v["value"] for k, v in ref_gauges.items()}
    if which == "other-rows":
        assert all(v > 0 for v in counters.values())
    else:
        assert all(v == 0 for v in counters.values())
    assert _read(tmp_path / "port") == _read(runbook / "model_jax")


@pytest.mark.parametrize("how", ["missing", "garbled"])
def test_drift_baseline_load_failure_does_not_fail_the_job(
        runbook, tmp_path, capfd, how):
    baseline = str(tmp_path / "baseline")
    if how == "garbled":
        os.makedirs(baseline)
        with open(os.path.join(baseline, "part-r-00000"), "wb") as fh:
            fh.write(b"\xff\xfe\x00garbled\x80\x81\n" * 16)
    ref_counters, _ = _drift_run(jb, JaxConfig, runbook,
                                 str(tmp_path / "ref"), baseline)
    ref_err = capfd.readouterr().err
    counters, _ = _drift_run(tb, JobConfig, runbook,
                             str(tmp_path / "port"), baseline)
    err = capfd.readouterr().err
    assert counters == ref_counters == {"Baseline load failed": 1}
    line = [l for l in err.splitlines() if l.startswith("drift:")]
    assert line == [l for l in ref_err.splitlines()
                    if l.startswith("drift:")]
    assert len(line) == 1 and baseline in line[0]
    assert _read(tmp_path / "port") == _read(runbook / "model_jax")


# ---------------------------------------------------------------------------
# the two other NB runbooks, through both command lines
# ---------------------------------------------------------------------------

NB_RUNBOOKS = {"elearn_nb": ("elearn", "3", "elearn.json"),
               "usage_churn_nb": ("usage", "9", "usage.json")}


def _nb_runbook(work, name, main, dg, extra=()):
    """resource/<name>/run.sh's steps (4,000 generated rows, 3,200 trained,
    800 scored) with the working directory at the runbook's layout."""
    import contextlib
    import io

    preset, seed, schema = NB_RUNBOOKS[name]
    book = os.path.join(REPO, "resource", name)
    os.makedirs(os.path.join(work, "work", "train"))
    os.makedirs(os.path.join(work, "work", "test"))
    shutil.copy(os.path.join(book, schema), work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert dg([preset, "4000", "--seed", seed,
                   "--out", "work/all.csv"]) == 0
        with open("work/all.csv") as fh:
            lines = fh.read().splitlines(keepends=True)
        with open("work/train/part-00000", "w") as fh:
            fh.writelines(lines[:3200])
        with open("work/test/part-00000", "w") as fh:
            fh.writelines(lines[-800:])
        for argv in (["BayesianDistribution",
                      f"-Dconf.path={book}/nb.properties", "work/train",
                      "work/model"],
                     ["BayesianPredictor", f"-Dconf.path={book}/bp.properties",
                      "work/test", "work/pred"]):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = main(argv + list(extra))
            assert rc in (0, None), err.getvalue()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def nb_runbooks(tmp_path_factory):
    from avenir_tpu.cli import main as jax_main
    from avenir_tpu.datagen.cli import main as jax_datagen

    from avenir_tpu_torch.cli import main as port_main

    tmp = tmp_path_factory.mktemp("nb_runbooks")
    for name in NB_RUNBOOKS:
        _nb_runbook(str(tmp / name / "jax"), name, jax_main, jax_datagen)
        _nb_runbook(str(tmp / name / "port"), name, port_main, datagen.main,
                    extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("output", ["all.csv", "model", "pred"])
@pytest.mark.parametrize("name", sorted(NB_RUNBOOKS))
def test_nb_runbook_byte_identical(nb_runbooks, name, output):
    """resource/elearn_nb and resource/usage_churn_nb through
    ``python -m avenir_tpu_torch ... --device cpu``: the port's generated
    data, model and predictions are the reference's bytes."""
    def read(side):
        path = nb_runbooks / name / side / "work" / output
        if output == "all.csv":
            with open(path, "rb") as fh:
                return fh.read()
        return _read(path)

    got = read("port")
    assert got == read("jax")
    assert len(got.splitlines()) == {"all.csv": 4000, "pred": 800}.get(
        output, len(got.splitlines()))
