"""Every job of the port on a device mesh, held against the reference.

The reference runs its jobs on the eight virtual CPU devices of
``tests/conftest.py`` (``mesh8``); the port runs the same seeded input on
``make_mesh([cpu] * 8)`` (8 x 1, and 4 x 2 where the reference's tests use
another shape), where each position computes its shard on the one CPU.
Counts are integers and scoring is row-local, so every output must equal
the reference's byte for byte, and the port's one-device output: Naive
Bayes training (monolithic, streamed cold, warm off the ingest cache with
the fused binning, text mode), ``BayesianPredictor`` at float64 and
float32, a streamed NB kill and resume on the mesh, ``mesh=`` on every
job's ``run``, and ``AVENIR_MESH`` through the command line.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pickle

import numpy as np
import pytest
import torch

from avenir_tpu.cli import JOBS as JAX_JOBS
from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.datagen import gen_telecom_churn, gen_text_classified
from avenir_tpu.models import bayesian as jb

from avenir_tpu_torch import cli
from avenir_tpu_torch.core import faultinject
from avenir_tpu_torch.core.binning import DatasetEncoder
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.faultinject import (FaultInjector, InjectedFault,
                                               parse_plan)
from avenir_tpu_torch.core.io import write_output
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.models import bayesian as tb
from avenir_tpu_torch.ops import counting
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = os.path.join(REPO, "resource", "churn_nb", "teleComChurn.json")
CPU = torch.device("cpu")
SHAPES = {"8x1": (8, 1), "4x2": (4, 2)}
N_TRAIN, CHUNK_ROWS = 2400, 256
N_CHUNKS = -(-N_TRAIN // CHUNK_ROWS)


def _mesh(shape: str):
    data, model = SHAPES[shape]
    return pmesh.make_mesh([CPU] * 8, data=data, model=model)


def _read(path) -> bytes:
    with open(os.path.join(str(path), "part-r-00000"), "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    """2,400 training and 600 test churn rows (seed 29)."""
    d = tmp_path_factory.mktemp("torch_mesh_jobs")
    rows = [",".join(r) for r in gen_telecom_churn(3000, seed=29)]
    write_output(str(d / "train"), rows[:N_TRAIN])
    write_output(str(d / "test"), rows[N_TRAIN:])
    return d


@pytest.fixture
def folds(monkeypatch):
    """The position count of every sharded fold the test runs (each call
    of ``ops.counting.sharded_reduce_resident``)."""
    seen = []
    resident = counting.sharded_reduce_resident

    def spy(*a, **kw):
        seen.append(kw["mesh"].size)
        return resident(*a, **kw)
    monkeypatch.setattr(counting, "sharded_reduce_resident", spy)
    return seen


@pytest.fixture(autouse=True)
def _no_injector():
    yield
    faultinject.set_injector(None)


def _train_both(props, inp, out, mesh8, port_mesh):
    """NB training through each package; returns (reference, port)
    model bytes and the port's counters."""
    jb.BayesianDistribution(JaxConfig(dict(props))).run(
        str(inp), str(out) + "_jax", mesh=mesh8)
    pc = tb.BayesianDistribution(JobConfig(dict(props)), device="cpu").run(
        str(inp), str(out) + "_port", mesh=port_mesh)
    return _read(str(out) + "_jax"), _read(str(out) + "_port"), pc


# ---------------------------------------------------------------------------
# Naive Bayes training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_nb_monolithic_on_a_mesh(churn, mesh8, folds, shape):
    """``train_lines`` (the one-shot pass) with ``sharded_reduce(mesh=)``:
    the reference's lines on ``mesh8`` and the port's one-device lines."""
    train = str(churn / "train")
    jjob = jb.BayesianDistribution(JaxConfig({"feature.schema.file.path":
                                              SCHEMA}))
    want = jjob.train_lines(JaxEncoder(jjob.schema).encode_path(train), ",",
                            JaxCounters(), mesh=mesh8)
    pjob = tb.BayesianDistribution(JobConfig({"feature.schema.file.path":
                                              SCHEMA}), device="cpu")
    ds = DatasetEncoder(pjob.schema).encode_path(train)
    one = pjob.train_lines(ds, ",", Counters())
    assert folds == []
    got = pjob.train_lines(ds, ",", Counters(), mesh=_mesh(shape))
    assert got == want == one
    assert folds == [8]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("depth", [0, 2])
def test_nb_streamed_cold_on_a_mesh(churn, tmp_path, mesh8, folds, shape,
                                    depth):
    """The streamed trainer in 256-row chunks: every chunk's rows shard
    over the eight positions; the model equals the reference's on
    ``mesh8`` and the port's one-device model."""
    props = {"feature.schema.file.path": SCHEMA,
             "pipeline.chunk.rows": str(CHUNK_ROWS),
             "pipeline.prefetch.depth": str(depth)}
    want, got, pc = _train_both(props, churn / "train", tmp_path / "m",
                                mesh8, _mesh(shape))
    tb.BayesianDistribution(JobConfig(dict(props)), device="cpu").run(
        str(churn / "train"), str(tmp_path / "one"))
    assert got == want == _read(tmp_path / "one")
    assert pc.get("Ingest", "Chunks") == N_CHUNKS
    assert folds == [8] * N_CHUNKS


@pytest.mark.parametrize("fused", ["true", "false"], ids=["K2", "K1"])
def test_nb_warm_on_a_mesh(churn, tmp_path, mesh8, folds, monkeypatch,
                           fused):
    """Cold on the mesh writing the ingest cache, then warm off it: with
    ``ingest.cache.fused`` the pre-bin integers shard over the positions
    and bin inside the count (K2's ``_nb_local_rawbin``), else the stored
    bins fold with K1's ``_nb_local``; both equal the reference's
    cold model."""
    calls = []
    rawbin = tb._nb_local_rawbin

    def spy(*a, **kw):
        calls.append(a[0].device)
        return rawbin(*a, **kw)
    monkeypatch.setattr(tb, "_nb_local_rawbin", spy)
    props = {"feature.schema.file.path": SCHEMA,
             "pipeline.chunk.rows": str(CHUNK_ROWS),
             "ingest.cache.enable": "true",
             "ingest.cache.fused": fused,
             "ingest.cache.dir": str(tmp_path / "cache")}
    jb.BayesianDistribution(JaxConfig({"feature.schema.file.path": SCHEMA})
                            ).run(str(churn / "train"), str(tmp_path / "ref"),
                                  mesh=mesh8)
    want = _read(tmp_path / "ref")
    for shape, tag in (("8x1", "cold"), ("4x2", "warm")):
        tb.BayesianDistribution(JobConfig(dict(props)), device="cpu").run(
            str(churn / "train"), str(tmp_path / tag), mesh=_mesh(shape))
        assert _read(tmp_path / tag) == want, tag
        assert os.listdir(tmp_path / "cache")
    assert folds == [8] * (2 * N_CHUNKS)
    # the warm run: one rawbin fold a position a chunk, or none
    assert len(calls) == (8 * N_CHUNKS if fused == "true" else 0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_nb_text_mode_on_a_mesh(tmp_path, mesh8, folds, shape):
    """``tabular.input=false``: the (token, class) count at F = 1 over the
    token vocabulary, sharded over the positions; the reference's model
    on ``mesh8``."""
    rows = gen_text_classified(300, seed=4)
    write_output(str(tmp_path / "in"), [",".join(r) for r in rows])
    want, got, _ = _train_both({"tabular.input": "false"}, tmp_path / "in",
                               tmp_path / "t", mesh8, _mesh(shape))
    assert got == want
    assert folds == [8]


def test_nb_kill_resume_on_a_mesh(churn, tmp_path, mesh8, folds):
    """An ``h2d`` fault kills the streamed trainer on eight positions after
    its third-chunk checkpoint; the resumed run on the mesh seeds the
    carry on the mesh's first device and writes the reference's
    uninterrupted model (``tests/test_resilience.py``'s form)."""
    props = {"feature.schema.file.path": SCHEMA,
             "pipeline.chunk.rows": str(CHUNK_ROWS),
             "checkpoint.interval.chunks": "3"}
    jb.BayesianDistribution(JaxConfig({"feature.schema.file.path": SCHEMA})
                            ).run(str(churn / "train"), str(tmp_path / "ref"),
                                  mesh=mesh8)
    out = str(tmp_path / "out")
    faultinject.set_injector(FaultInjector(parse_plan("h2d@5")))
    with pytest.raises(InjectedFault):
        tb.BayesianDistribution(JobConfig(dict(props)), device="cpu").run(
            str(churn / "train"), out, mesh=_mesh("8x1"))
    faultinject.set_injector(None)
    with open(out + ".ckpt", "rb") as fh:
        payload = pickle.load(fh)
    assert payload["chunk_index"] == 2
    assert isinstance(payload["carry"], np.ndarray)
    killed = len(folds)
    resumed = dict(props, **{"checkpoint.resume": "true"})
    tb.BayesianDistribution(JobConfig(resumed), device="cpu").run(
        str(churn / "train"), out, mesh=_mesh("4x2"))
    assert _read(out) == _read(tmp_path / "ref")
    assert not os.path.exists(out + ".ckpt")
    # the resumed run folded only the chunks after the checkpoint
    assert folds[killed:] == [8] * (N_CHUNKS - 3)


# ---------------------------------------------------------------------------
# Naive Bayes scoring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model(churn):
    jb.BayesianDistribution(JaxConfig({"feature.schema.file.path": SCHEMA})
                            ).run(str(churn / "train"), str(churn / "model"))
    return str(churn / "model")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("prob_only", ["false", "true"])
def test_predictor_on_a_mesh(churn, model, tmp_path, mesh8, shape,
                             precision, prob_only):
    """Rows shard over the ``data`` axis (8 or 4 shards) and each shard
    is scored on its device: the one-device bytes at both precisions, and
    the reference's bytes on ``mesh8`` at float64 (the float32 scorer is
    held to the reference by its parity contract in
    ``tests/test_torch_bayesian.py``)."""
    cfg = {"feature.schema.file.path": SCHEMA,
           "bayesian.model.file.path": model,
           "bp.score.precision": precision,
           "output.feature.prob.only": prob_only}
    pc = tb.BayesianPredictor(JobConfig(dict(cfg), "bp"), device="cpu").run(
        str(churn / "test"), str(tmp_path / "mesh"), mesh=_mesh(shape))
    oc = tb.BayesianPredictor(JobConfig(dict(cfg), "bp"), device="cpu").run(
        str(churn / "test"), str(tmp_path / "one"))
    assert _read(tmp_path / "mesh") == _read(tmp_path / "one")
    assert pc.as_dict() == oc.as_dict()
    if precision == "float64":
        jc = jb.BayesianPredictor(JaxConfig(dict(cfg), "bp")).run(
            str(churn / "test"), str(tmp_path / "jax"), mesh=mesh8)
        assert _read(tmp_path / "mesh") == _read(tmp_path / "jax")
        assert pc.as_dict() == jc.as_dict()


def test_predictor_scores_each_data_shard_once(churn, model, monkeypatch):
    """On 4 x 2 the four data shards are scored, one call each on padded
    rows, and the model axis adds no call."""
    cfg = {"feature.schema.file.path": SCHEMA,
           "bayesian.model.file.path": model}
    job = tb.BayesianPredictor(JobConfig(dict(cfg), "bp"), device="cpu")
    rows = []
    real = tb.BayesianPredictor._score_batch_f32

    def spy(x, *a):
        rows.append(x.shape[0])
        return real(x, *a)
    monkeypatch.setattr(tb.BayesianPredictor, "_score_batch_f32",
                        staticmethod(spy))
    records = [line.split(",") for line in
               _read(churn / "test").decode().splitlines()[:599]]
    _, _, probs, _, _ = job.score(records, _mesh("4x2"))
    assert rows == [150] * 4              # 599 rows padded to 600
    assert probs.shape == (599, 2)


# ---------------------------------------------------------------------------
# mesh= on every job, AVENIR_MESH on the command line
# ---------------------------------------------------------------------------

def test_every_job_takes_a_mesh():
    """Every class in the port's ``JOBS`` accepts ``run(in, out, mesh=)``,
    as the reference's ``tests/test_serve.py`` asks of its own, with the
    same one exception: the streaming topology's long-lived event loop."""
    assert set(cli.JOBS) == set(JAX_JOBS)
    missing = []
    for fqcn, (modname, clsname, _) in cli.JOBS.items():
        cls = getattr(importlib.import_module(
            f"avenir_tpu_torch.models.{modname}"), clsname)
        if "mesh" not in inspect.signature(cls.run).parameters:
            missing.append(fqcn)
    assert missing == ["org.avenir.reinforce.ReinforcementLearnerTopology"]


@pytest.mark.parametrize("spec,shape", [("8x1", (8, 1)), ("4x2", (4, 2)),
                                        ("1x1", (1, 1))])
def test_avenir_mesh_on_the_cpu(monkeypatch, spec, shape):
    """With ``--device cpu`` ``AVENIR_MESH=<d>x<m>`` names the CPU d x m
    times; unset, the one device."""
    monkeypatch.setenv("AVENIR_MESH", spec)
    m = cli.cli_mesh("cpu")
    assert (m.shape["data"], m.shape["model"]) == shape
    assert set(m.devices.flat) == {CPU}
    assert cli.run_mesh("cpu").shape == m.shape
    monkeypatch.setenv("AVENIR_MESH", "0x2")
    with pytest.raises(ValueError, match="bad AVENIR_MESH"):
        cli.cli_mesh("cpu")
    monkeypatch.delenv("AVENIR_MESH")
    assert cli.cli_mesh("cpu") is None
    assert list(cli.run_mesh("cpu").devices.flat) == [CPU]


def test_avenir_mesh_reaches_a_job_through_the_cli(churn, tmp_path, mesh8,
                                                   folds, monkeypatch):
    """``AVENIR_MESH=4x2 python -m avenir_tpu_torch BayesianDistribution
    ... --device cpu``: the streamed fold runs on eight positions and the
    model is the reference's on ``mesh8``."""
    jb.BayesianDistribution(JaxConfig({"feature.schema.file.path": SCHEMA})
                            ).run(str(churn / "train"), str(tmp_path / "ref"),
                                  mesh=mesh8)
    monkeypatch.setenv("AVENIR_MESH", "4x2")
    rc = cli.main(["BayesianDistribution", f"-Dfeature.schema.file.path="
                   f"{SCHEMA}", f"-Dpipeline.chunk.rows={CHUNK_ROWS}",
                   str(churn / "train"), str(tmp_path / "out"),
                   "--device", "cpu"])
    assert rc == 0
    assert _read(tmp_path / "out") == _read(tmp_path / "ref")
    assert folds == [8] * N_CHUNKS


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["multi", "dag", "serve"])
def test_avenir_mesh_reaches_multi_dag_and_serve(tmp_path, monkeypatch,
                                                 entry):
    """``multi``, ``dag`` and ``serve`` hand ``AVENIR_MESH``'s mesh to
    ``run_multi``, ``run_workflow`` and ``PredictionServer``, and build
    their jobs on its first device; unset, the one device of
    ``--device``."""
    from avenir_tpu_torch.core import dag, multiscan
    from avenir_tpu_torch.serve import server

    seen = []

    def capture(*a, mesh=None, **kw):
        seen.append(mesh)
        if entry == "serve":
            raise _Stop
        resolver = a[3]
        assert resolver.device == mesh.devices.flat[0]
        return {}
    target = {"multi": (multiscan, "run_multi"),
              "dag": (dag, "run_workflow"),
              "serve": (server, "PredictionServer")}[entry]
    monkeypatch.setattr(*target, capture)
    (tmp_path / "c.properties").write_text("serve.models=churn\n")
    argv = [entry, f"-Dconf.path={tmp_path / 'c.properties'}",
            str(tmp_path / "in"), "--device", "cpu"]
    for spec in ("4x2", None):
        if spec is None:
            monkeypatch.delenv("AVENIR_MESH")
        else:
            monkeypatch.setenv("AVENIR_MESH", spec)
        if entry == "serve":
            with pytest.raises(_Stop):
                cli.main(argv[:2] + argv[3:])
        else:
            assert cli.main(argv) == 0
    assert seen[0].shape == {"data": 4, "model": 2}
    assert set(seen[0].devices.flat) == {CPU}
    if entry == "serve":
        assert seen[1] is None
    else:
        assert list(seen[1].devices.flat) == [CPU]


# ---------------------------------------------------------------------------
# the serving registry on a mesh (the DAG's publish stage builds one)
# ---------------------------------------------------------------------------

KNN_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "a", "ordinal": 1, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "b", "ordinal": 2, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "cls", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["N", "Y"]}]}


def _knn_props(tmp):
    """``tests/test_serve.py``'s kNN model: 90 training rows, 30
    queries."""
    import json

    (tmp / "knn_schema.json").write_text(json.dumps(KNN_SCHEMA))
    rng = np.random.default_rng(7)
    rows = []
    for i in range(120):
        y = i % 2
        a = float(np.clip(rng.normal(3 + 4 * y, 1.0), 0, 10))
        b = float(np.clip(rng.normal(7 - 4 * y, 1.0), 0, 10))
        rows.append(f"K{i},{a:.3f},{b:.3f},{'Y' if y else 'N'}")
    (tmp / "knn_train.csv").write_text("\n".join(rows[:90]) + "\n")
    props = {"serve.models": "nn", "serve.model.nn.kind": "nearestNeighbor",
             "serve.model.nn.top.match.count": "5",
             "serve.model.nn.kernel.function": "none",
             "serve.model.nn.validation.mode": "true",
             "serve.model.nn.feature.schema.file.path":
                 str(tmp / "knn_schema.json"),
             "serve.model.nn.train.data.path": str(tmp / "knn_train.csv")}
    return props, rows[90:]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_registry_on_a_mesh_ranks_over_it(tmp_path, mesh8, monkeypatch,
                                          shape):
    """``ModelRegistry(config, mesh=)``: the kNN adapter ranks through
    ``pairwise_distances(mesh=)`` and answers as the one-device adapter
    and the reference's registry on ``mesh8``; the bandit adapter's store
    is built over the mesh."""
    from avenir_tpu.serve.registry import ModelRegistry as JaxRegistry
    from avenir_tpu.stream.posterior import clear_stores as jclear

    from avenir_tpu_torch.ops import distance
    from avenir_tpu_torch.serve.registry import ModelRegistry
    from avenir_tpu_torch.stream.posterior import clear_stores

    meshes = []
    real = distance.pairwise_distances

    def spy(*a, **kw):
        meshes.append(kw.get("mesh"))
        return real(*a, **kw)
    monkeypatch.setattr(distance, "pairwise_distances", spy)
    props, queries = _knn_props(tmp_path)
    pm = _mesh(shape)
    on_mesh = ModelRegistry(JobConfig(dict(props)), device="cpu", mesh=pm)
    assert torch.device(on_mesh.device) == CPU
    got = on_mesh.load("nn").adapter.predict_lines(queries)
    one = ModelRegistry(JobConfig(dict(props)), device="cpu").load(
        "nn").adapter.predict_lines(queries)
    want = JaxRegistry(JaxConfig(dict(props)), mesh=mesh8).load(
        "nn").adapter.predict_lines(queries)
    assert got == one == want
    assert meshes == [pm]
    bandit = {"serve.models": "m", "serve.model.m.kind": "banditDecision",
              "serve.model.m.stream.tenants": "t1,t2",
              "serve.model.m.stream.arms": "a,b,c",
              "serve.model.m.stream.store": "mesh-jobs"}
    try:
        ad = ModelRegistry(JobConfig(dict(bandit)), mesh=pm).load(
            "m").adapter
        assert ad.store.mesh is pm
        jad = JaxRegistry(JaxConfig(dict(bandit)), mesh=mesh8).load(
            "m").adapter
        lines = ["ev-7,t2", "ev-8,t1", "ev-9,t2"]
        assert ad.predict_lines(lines) == jad.predict_lines(lines)
    finally:
        clear_stores()
        jclear()
