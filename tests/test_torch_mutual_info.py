"""The port's mutual-information job (``avenir_tpu_torch/models/
mutual_info.py``) held against the JAX package's on the CPU.

``resource/hosp_readmit_mi`` runs through both command lines on the same
seeded rows (``avenir_tpu.datagen``); every other case runs the job
objects side by side: every score algorithm, the job on the port's
8-position CPU mesh against the reference on ``mesh8``, the streamed path
(cold, then warm off the ingest cache, and its fallbacks) against the
reference's monolithic bytes, the count function against the
reference's, and the pair-table budget's refusal.  Counts are integers
and every statistic is host ``math.log``, so every comparison is byte
equality.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.datagen import gen_hosp_readmit
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import mutual_info as jmi

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import mutual_info as tmi
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK = os.path.join(REPO, "resource", "hosp_readmit_mi")
HOSP = os.path.join(BOOK, "hosp_readmit.json")
CHURN = os.path.join(REPO, "resource", "churn_cramer", "churn.json")
CPU = torch.device("cpu")
ALGOS = ["mutual.info.maximization", "mutual.info.selection",
         "joint.mutual.info", "double.input.symmetric.relevance",
         "min.redundancy.max.relevance"]


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _job(main, *argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(list(argv))
    assert rc in (0, None), err.getvalue()
    return err.getvalue()


@pytest.fixture(scope="module")
def hosp(tmp_path_factory):
    """The runbook's rows (hosp_readmit 6000, seed 13) through both
    command lines, and a 1,500-row copy for the job-object cases."""
    tmp = tmp_path_factory.mktemp("torch_mi")
    for name, main, dg, extra in (("jax", jax_main, jax_datagen, ()),
                                  ("port", port_main, datagen.main,
                                   ("--device", "cpu"))):
        work = tmp / name
        os.makedirs(work)
        shutil.copy(HOSP, work)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            assert dg(["hosp_readmit", "6000", "--seed", "13",
                       "--out", "work/in/part-00000"]) == 0
            _job(main, "MutualInformation", f"-Dconf.path={BOOK}/mi.properties",
                 "work/in", "work/out", *extra)
        finally:
            os.chdir(cwd)
    rows = [",".join(r) for r in gen_hosp_readmit(1500, seed=13)]
    write_output(str(tmp / "in"), rows)
    return tmp


def test_runbook_byte_identical(hosp):
    got = _read(hosp / "port" / "work" / "out")
    assert got == _read(hosp / "jax" / "work" / "out")
    text = got.decode()
    for section in ("distribution:featurePairClassConditional",
                    "mutualInformation:featurePairClassConditional",
                    "mutualInformationScoreAlgorithm: "
                    "mutual.info.maximization"):
        assert section in text


def _props(**over):
    props = {"feature.schema.file.path": HOSP,
             "mutual.info.score.algorithms": ",".join(ALGOS),
             "mutual.info.redundancy.factor": "0.7"}
    props.update(over)
    return props


def _both(tmp, tag, mesh8=None, port_mesh=None, jax_props=None, **over):
    """The job of each package on ``tmp/in``; returns (jax, port) bytes."""
    jmi.MutualInformation(JaxConfig(_props(**(jax_props or over)))).run(
        str(tmp / "in"), str(tmp / f"{tag}_jax"), mesh=mesh8)
    tmi.MutualInformation(JobConfig(_props(**over)), device="cpu").run(
        str(tmp / "in"), str(tmp / f"{tag}_port"), mesh=port_mesh)
    return _read(tmp / f"{tag}_jax"), _read(tmp / f"{tag}_port")


@pytest.fixture(scope="module")
def every_algorithm(hosp, mesh8):
    want, got = _both(hosp, "algos", mesh8)
    assert got == want
    return got.decode().splitlines()


def _section(lines, alg):
    start = lines.index(f"mutualInformationScoreAlgorithm: {alg}") + 1
    end = start
    while end < len(lines) and "Algorithm:" not in lines[end]:
        end += 1
    return lines[start:end]


@pytest.mark.parametrize("alg", ALGOS)
def test_every_score_algorithm(every_algorithm, hosp, alg):
    got = _section(every_algorithm, alg)
    ords = sorted(int(line.split(",")[0]) for line in got)
    assert ords == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]     # each feature once
    want = _section(_read(hosp / "algos_jax").decode().splitlines(), alg)
    assert got == want


def test_mesh_matches_reference(hosp, mesh8):
    want, got = _both(hosp, "mesh", mesh8,
                      pmesh.make_mesh([CPU] * 8, data=4, model=2))
    assert got == want


@pytest.mark.parametrize("chunk", [256, 1000, 4096])
def test_streamed_and_warm_cache_equal_monolithic(hosp, mesh8, chunk):
    """Streamed cold (writing the ingest cache), then warm off it: the
    reference's monolithic bytes both times, the warm run parsing no
    input row."""
    cache = hosp / f"cache{chunk}"
    over = {"pipeline.chunk.rows": str(chunk), "ingest.cache.enable": "true",
            "ingest.cache.dir": str(cache)}
    want, cold = _both(hosp, f"cold{chunk}", mesh8, jax_props={}, **over)
    assert cold == want
    assert os.listdir(cache)
    from avenir_tpu_torch.core import pipeline
    calls = []
    real = pipeline.iter_field_chunks

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    pipeline.iter_field_chunks = spy
    try:
        tmi.MutualInformation(JobConfig(_props(**over)), device="cpu").run(
            str(hosp / "in"), str(hosp / f"warm{chunk}"))
    finally:
        pipeline.iter_field_chunks = real
    assert calls == []
    assert _read(hosp / f"warm{chunk}") == want


def test_streamed_fold_counts_equal_the_references(hosp):
    """The streamed carry, table for table, against the reference's
    ``_mi_local`` over the whole input."""
    cfg = JobConfig(_props())
    job = tmi.MutualInformation(cfg, device="cpu")
    from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    ds = JaxEncoder(JaxSchema.from_file(HOSP)).encode_path(str(hosp / "in"))
    F = ds.n_features
    C, B = len(ds.class_vocab), max(ds.num_bins)
    pi, pj = map(tuple, np.triu_indices(F, k=1))
    want = jmi._mi_local(ds.x, ds.y, np.ones(ds.n_rows, bool), C, B, pi, pj)
    got = None
    for lo in range(0, ds.n_rows, 400):
        x = torch.from_numpy(ds.x[lo:lo + 400])
        y = torch.from_numpy(ds.y[lo:lo + 400])
        got = tmi._mi_local(x, y, None, C, B, pi, pj, out=got)
    for key in ("fc", "pc"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert job.device == CPU


def test_streamed_falls_back_on_a_late_class_or_negative_bin(tmp_path, mesh8):
    """A class value first seen past the cap, and a negative bin: the
    streamed path hands over to the one-shot encode, same bytes."""
    rows = [",".join(r) for r in gen_hosp_readmit(600, seed=3)]
    late = rows + [rows[0].rsplit(",", 1)[0] + ",M",
                   rows[1].rsplit(",", 1)[0] + ",Q",
                   rows[2].rsplit(",", 1)[0] + ",Z"]
    f = rows[3].split(",")
    f[1] = "-15"                       # age -15: a negative bin
    for tag, data in (("late", late), ("negative", rows + [",".join(f)])):
        write_output(str(tmp_path / "in"), data)
        want, got = _both(tmp_path, tag, mesh8, jax_props={},
                          **{"pipeline.chunk.rows": "200"})
        assert got == want, tag


def test_streamed_path_refuses_a_mesh(hosp):
    job = tmi.MutualInformation(JobConfig(_props(**{
        "pipeline.chunk.rows": "500"})), device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        job.run(str(hosp / "in"), str(hosp / "refused"),
                mesh=pmesh.make_mesh([CPU] * 2))


def test_mi_local_matches_reference_with_mask():
    rng = np.random.default_rng(5)
    n, F, C, B = 700, 4, 3, 6
    x = rng.integers(-1, B + 1, (n, F)).astype(np.int32)
    y = rng.integers(-1, C + 1, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    pi, pj = map(tuple, np.triu_indices(F, k=1))
    want = jmi._mi_local(x, y, mask, C, B, pi, pj)
    got = tmi._mi_local(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(mask), C, B, pi, pj)
    for key in ("fc", "pc"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("budget", ["1000", "100000000"])
def test_pair_table_budget(budget):
    """A budget below the declared pair table refuses the job at
    construction with the reference's message; a large one admits it."""
    props = _props(**{"pipeline.device.budget.bytes": budget})
    try:
        jmi.MutualInformation(JaxConfig(props))
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        tmi.MutualInformation(JobConfig(props), device="cpu")
    else:
        with pytest.raises(ValueError) as err:
            tmi.MutualInformation(JobConfig(props), device="cpu")
        assert str(err.value) == want
    assert tmi.pair_table_bytes(10, 12, 2) == jmi.pair_table_bytes(10, 12, 2)


def test_unbinned_numeric_feature_is_refused():
    """The churn schema leaves ``network`` unbinned: both packages refuse
    it."""
    props = {"feature.schema.file.path": CHURN}
    with pytest.raises(ValueError, match="bucketWidth on numeric feature "
                                         "'network'"):
        jmi.MutualInformation(JaxConfig(props))
    with pytest.raises(ValueError, match="bucketWidth on numeric feature "
                                         "'network'"):
        tmi.MutualInformation(JobConfig(props), device="cpu")


def test_mi_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmi.MutualInformation(JobConfig(_props()))
