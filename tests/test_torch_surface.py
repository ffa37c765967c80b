"""The last names of the JAX package's surface held against their port,
on the CPU, and the port's default mesh.

Each name the census (``tests/test_torch_census.py``) found missing gets
the same seeded input in both packages and must give the same answer:
``ops.counting.moment_table`` (counts equal as int64, sums within
``rtol=1e-12``, bit for bit where the values are integers),
``cli.register``, ``JobConfig.from_file``, ``OutputWriter.write_all``,
``EncodedDataset.ids``, the schema helpers, ``resilience.get_policy`` and
``mesh.data_axis_size``.  The default mesh is checked with a patched card
count: no tensor is made on a card.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from avenir_tpu import cli as jcli
from avenir_tpu.core import binning as jbinning
from avenir_tpu.core import config as jconfig
from avenir_tpu.core import io as jio
from avenir_tpu.core import resilience as jresilience
from avenir_tpu.core import schema as jschema
from avenir_tpu.datagen import gen_telecom_churn
from avenir_tpu.ops import counting as jcounting
from avenir_tpu.parallel import mesh as jmesh

from avenir_tpu_torch import cli, ops
from avenir_tpu_torch.core import binning, config, io, resilience, schema
from avenir_tpu_torch.ops import counting
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHURN_DIR = os.path.join(REPO, "resource", "churn_nb")
CHURN_SCHEMA = os.path.join(CHURN_DIR, "teleComChurn.json")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# moment_table
# ---------------------------------------------------------------------------

def _moment_inputs(case, seed):
    """Seeded (sizes, indices, values, mask): indices reach outside their
    ranges on both sides, and the mask drops about a fifth of the rows."""
    rng = np.random.default_rng(seed)
    n = 2048
    if case == "nb":     # the NB shape: C[class, feature, bin] over rows
        C, F, B = 3, 5, 9
        y = rng.integers(-1, C + 1, size=(n, 1))
        f = np.arange(F)[None, :]
        x = rng.integers(-2, B + 2, size=(n, F))
        sizes, idx, shape = (C, F, B), [y, f, x], (n, F)
        mask = rng.random((n, 1)) > 0.2
    else:                # one flat key
        sizes, shape = (17,), (n,)
        idx = [rng.integers(-3, 20, size=n)]
        mask = rng.random(n) > 0.2
    if case == "integer":
        values = rng.integers(-10 ** 6, 10 ** 6, size=shape).astype(
            np.float64)
    else:
        values = rng.normal(50.0, 400.0, size=shape)
    return sizes, idx, values, mask


@pytest.mark.parametrize("case", ["flat", "integer", "nb"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_moment_table_matches_reference(case, masked):
    sizes, idx, values, mask = _moment_inputs(case, seed=17)
    mask = mask if masked else None
    want = jcounting.moment_table(
        sizes, [np.asarray(i) for i in idx], values,
        mask=None if mask is None else np.asarray(mask))
    got = ops.moment_table(
        sizes, [torch.from_numpy(i) for i in idx], torch.from_numpy(values),
        mask=None if mask is None else torch.from_numpy(mask))
    cnt, s1, s2 = (np.asarray(t) for t in want)
    assert got[0].dtype == torch.int64 and cnt.dtype == np.int64
    assert all(t.dtype == torch.float64 and t.device == CPU for t in got[1:])
    np.testing.assert_array_equal(got[0].numpy(), cnt)
    assert cnt.sum() > 0 and cnt.sum() < values.size    # some dropped
    for mine, theirs in zip(got[1:], (s1, s2)):
        if case == "integer":
            np.testing.assert_array_equal(mine.numpy(), theirs)
        else:
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-12,
                                       atol=0)


def test_moment_table_drops_what_count_table_drops():
    """Its count channel is ``count_table``'s table over the same keys."""
    sizes, idx, values, mask = _moment_inputs("nb", seed=5)
    t_idx = [torch.from_numpy(i) for i in idx]
    m = torch.from_numpy(mask)
    cnt, _, _ = counting.moment_table(sizes, t_idx, torch.from_numpy(values),
                                      mask=m)
    want = counting.count_table(sizes, t_idx, mask=m, dtype=torch.int64)
    assert torch.equal(cnt, want)


# ---------------------------------------------------------------------------
# the host surface: schema, config, writer, ids, register, policy
# ---------------------------------------------------------------------------

def test_schema_helpers_match_reference():
    mine = schema.FeatureSchema.from_file(CHURN_SCHEMA)
    theirs = jschema.FeatureSchema.from_file(CHURN_SCHEMA)
    got, want = mine.get_fields(), theirs.get_fields()
    assert got is mine.fields
    assert [f.name for f in got] == [f.name for f in want]
    for a, b in zip(got, want):
        assert (a.is_double(), a.is_numeric(), a.is_class_attr()) == \
            (b.is_double(), b.is_numeric(), b.is_class_attr()), a.name
        assert mine.field_by_name(a.name).ordinal == \
            theirs.field_by_name(a.name).ordinal
    assert mine.max_ordinal() == theirs.max_ordinal() == 7
    assert [f.name for f in got if f.is_class_attr()] == ["churned"]
    for s in (mine, theirs):
        with pytest.raises(KeyError, match="no field named nope"):
            s.field_by_name("nope")


@pytest.mark.parametrize("props", sorted(
    glob.glob(os.path.join(CHURN_DIR, "*.properties"))),
    ids=os.path.basename)
@pytest.mark.parametrize("prefix", ["", "bp"])
def test_job_config_from_file_matches_reference(props, prefix):
    mine = config.JobConfig.from_file(props, prefix)
    theirs = jconfig.JobConfig.from_file(props, prefix)
    assert isinstance(mine, config.JobConfig)
    assert mine.props == theirs.props and mine.props
    assert mine.prefix == theirs.prefix == prefix
    for key in sorted(theirs.props):
        short = key.partition(".")[2] if key.startswith("bp.") else key
        assert mine.get(short) == theirs.get(short)


def test_output_writer_write_all_matches_reference(tmp_path):
    lines = [",".join(r) for r in gen_telecom_churn(300, seed=3)]
    paths = []
    for pkg, sub in ((io, "mine"), (jio, "theirs")):
        w = pkg.OutputWriter(str(tmp_path / sub))
        w.write_all(iter(lines))
        w.close()
        paths.append(tmp_path / sub)
    for name in ("part-r-00000", "_SUCCESS", "_MANIFEST"):
        assert (paths[0] / name).read_bytes() == \
            (paths[1] / name).read_bytes()
    assert (paths[0] / "part-r-00000").read_text().splitlines() == lines


@pytest.fixture(scope="module")
def churn_csv(tmp_path_factory):
    rows = gen_telecom_churn(1500, seed=11)
    path = tmp_path_factory.mktemp("ids") / "churn.csv"
    path.write_text("\n".join(",".join(r) for r in rows) + "\n")
    return rows, str(path)


@pytest.mark.parametrize("form", ["native", "matrix", "records"])
def test_encoded_dataset_ids_match_reference(churn_csv, form):
    rows, path = churn_csv
    encs = (binning.DatasetEncoder(schema.FeatureSchema.from_file(
                CHURN_SCHEMA)),
            jbinning.DatasetEncoder(jschema.FeatureSchema.from_file(
                CHURN_SCHEMA)))
    if form == "native":
        mine, theirs = (e.encode_path(path) for e in encs)
        # the native ingest's bytes column, decoded on first access
        assert isinstance(mine.ids_raw, np.ndarray)
    elif form == "matrix":
        arr = np.asarray(rows, dtype=str)
        mine, theirs = (e.encode(arr) for e in encs)
    else:
        mine, theirs = (e.encode(iter([list(r) for r in rows]))
                        for e in encs)
    assert mine.ids == theirs.ids == [r[0] for r in rows]
    assert mine.ids is mine.ids              # decoded once
    assert binning.DatasetEncoder(encs[0].schema).encode([]).ids == []


def test_cli_register_then_resolve_matches_reference(monkeypatch):
    fq = "com.example.MyBayes"
    for pkg in (cli, jcli):
        monkeypatch.setattr(pkg, "JOBS", dict(pkg.JOBS))
        pkg.register(fq, "bayesian", "BayesianDistribution", "my")
    assert cli.resolve(fq) == jcli.resolve(fq) == \
        ("bayesian", "BayesianDistribution", "my")
    assert cli.resolve("MyBayes") == jcli.resolve("MyBayes")
    from avenir_tpu_torch.models.bayesian import BayesianDistribution
    assert cli.job_class("MyBayes") is BayesianDistribution
    assert set(cli.JOBS) == set(jcli.JOBS)


def test_get_policy_returns_what_set_policy_set():
    saved = (resilience.get_policy(), jresilience.get_policy())
    try:
        props = {"retry.max.attempts": "5", "retry.backoff.base.ms": "3",
                 "retry.seed": "9"}
        mine = resilience.set_policy(resilience.RetryPolicy.from_config(
            config.JobConfig(props)))
        theirs = jresilience.set_policy(jresilience.RetryPolicy.from_config(
            jconfig.JobConfig(props)))
        assert resilience.get_policy() is mine
        assert jresilience.get_policy() is theirs
        fields = ("max_attempts", "base_ms", "max_ms", "jitter")
        assert [getattr(mine, k) for k in fields] == \
            [getattr(theirs, k) for k in fields]
        assert [mine.backoff_s(a) for a in (1, 2, 3)] == \
            [theirs.backoff_s(a) for a in (1, 2, 3)]
    finally:
        resilience.set_policy(saved[0])
        jresilience.set_policy(saved[1])


def test_data_axis_size_on_a_2x2_cpu_mesh():
    mine = pmesh.make_mesh([CPU] * 4, data=2, model=2)
    theirs = jmesh.make_mesh(jax.devices("cpu")[:4], data=2, model=2)
    assert pmesh.data_axis_size(mine) == jmesh.data_axis_size(theirs) == 2
    assert pmesh.data_axis_size(pmesh.make_mesh([CPU] * 4)) == 4


# ---------------------------------------------------------------------------
# the default mesh: every visible card on the data axis
# ---------------------------------------------------------------------------

@pytest.fixture
def cards(monkeypatch):
    """Patch the visible card count (no tensor is ever made on a card)."""
    monkeypatch.delenv("AVENIR_MESH", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def set_count(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return set_count


def test_default_mesh_spans_every_card(cards):
    cards(4)
    every = [torch.device("cuda", i) for i in range(4)]
    for m in (pmesh.get_mesh(), pmesh.get_mesh("cuda"), cli.cli_mesh(None),
              cli.cli_mesh("cuda"), cli.run_mesh(None)):
        assert m.shape == {"data": 4, "model": 1}
        assert list(m.devices.flat) == every
    assert pmesh.data_axis_size() == 4


@pytest.mark.parametrize("count,device", [(1, None), (1, "cuda"),
                                          (4, "cuda:2"), (4, "cpu")])
def test_one_device_where_one_is_asked_for(cards, count, device):
    """One card, ``--device cuda:N`` or ``--device cpu``: no mesh, the
    command runs on the one device as before."""
    cards(count)
    assert cli.cli_mesh(device) is None
    want = (CPU if device == "cpu" else
            torch.device("cuda", 2) if device == "cuda:2" else
            torch.device("cuda", 0))
    assert list(cli.run_mesh(device).devices.flat) == [want]
    assert list(pmesh.get_mesh(device).devices.flat) == [want]


def test_avenir_mesh_unchanged(cards, monkeypatch):
    cards(4)
    monkeypatch.setenv("AVENIR_MESH", "2x2")
    for m in (pmesh.get_mesh(), cli.cli_mesh(None), cli.cli_mesh("cuda:2")):
        assert m.shape == {"data": 2, "model": 2}
        assert list(m.devices.flat) == [torch.device("cuda", i)
                                        for i in range(4)]
    m = cli.cli_mesh("cpu")
    assert m.shape == {"data": 2, "model": 2}
    assert set(m.devices.flat) == {CPU}


def test_no_card_no_mesh(monkeypatch):
    monkeypatch.delenv("AVENIR_MESH", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.cli_mesh(None) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_mesh(None)
