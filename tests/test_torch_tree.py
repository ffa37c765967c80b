"""The port's decision-tree family (``avenir_tpu_torch/models/tree.py``,
``models/split.py``) held against the JAX package's on the CPU.

``resource/decision_tree`` (three levels) and ``resource/retarget_tree``
run through both command lines on the same seeded rows
(``avenir_tpu.datagen``): the ``decpath.json`` and every level's records,
the root info, the candidate gains and the ``split=.../segment=...`` tree
must be byte-identical.  The count functions are held to both of the
reference's branches (the one-hot contraction, forced, and the scatter);
the level pass streamed, on the port's 8-position CPU mesh, and carried
across packages through ``decpath.json`` (a tree the reference began,
grown by the port, and the other way round) against the reference's
bytes; the candidate-split strategies and the partitioner's random pick
draw the same numbers as the reference's ``random.Random(seed)``.
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
from avenir_tpu.datagen import gen_retarget
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import tree as jt

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import tree as tt
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTB = os.path.join(REPO, "resource", "decision_tree")
RT = os.path.join(REPO, "resource", "retarget_tree")
SCHEMA = os.path.join(DTB, "retarget.json")
CPU = torch.device("cpu")
MESH8 = pmesh.make_mesh([CPU] * 8)


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _tree_files(root):
    """Every file under ``root`` (relative path -> bytes)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _runbooks(work, main, dg, extra=()):
    """resource/decision_tree/run.sh and resource/retarget_tree/run.sh
    with the working directory at their layout."""
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
        assert dg(["retarget", "2000", "--seed", "31",
                   "--out", "work/lvl0in/part-00000"]) == 0
        src = "work/lvl0in"
        for lvl in range(3):
            job("DecisionTreeBuilder", f"-Dconf.path={DTB}/dtb.properties",
                src, f"work/lvl{lvl + 1}")
            src = f"work/lvl{lvl + 1}"
        node = "work/campaign/split=root/data"
        assert dg(["retarget", "4000", "--seed", "31",
                   "--out", f"{node}/partition.txt"]) == 0
        job("ClassPartitionGenerator", f"-Dconf.path={RT}/root.properties",
            node, "work/rootout")
        with open("work/rootout/part-r-00000") as fh:
            parent = fh.readline().strip()
        job("SplitGenerator", f"-Dconf.path={RT}/splitgen.properties",
            f"-Dparent.info={parent}", "-", "-")
        job("DataPartitioner", f"-Dconf.path={RT}/dp.properties", "-", "-")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tree")
    _runbooks(str(tmp / "jax"), jax_main, jax_datagen)
    _runbooks(str(tmp / "port"), port_main, datagen.main,
              extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("name", ["decpath.json", "lvl1", "lvl2", "lvl3",
                                  "rootout", "campaign"])
def test_runbooks_byte_identical(runbooks, name):
    got = _tree_files(runbooks / "port" / "work" / name)
    want = _tree_files(runbooks / "jax" / "work" / name)
    if name == "decpath.json":
        got = {name: (runbooks / "port" / "work" / name).read_bytes()}
        want = {name: (runbooks / "jax" / "work" / name).read_bytes()}
    assert got == want
    assert got
    if name == "campaign":       # candidate gains and two segment trees
        assert any(k.startswith("split=root/splits") for k in got)
        assert any("segment=1" in k for k in got)


# ---------------------------------------------------------------------------
# the count functions against both of the reference's branches
# ---------------------------------------------------------------------------

def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("masked", [True, False])
def test_count_functions_match_both_reference_branches(masked):
    """Out-of-range paths, classes and segments (-1 and the size) drop in
    every form, as tests/test_tree.py holds the reference's two."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    n, n_paths, n_preds, n_class = 600, 5, 9, 3
    path_id = rng.integers(-1, n_paths + 1, n).astype(np.int32)
    y = rng.integers(-1, n_class + 1, n).astype(np.int32)
    bmat = rng.random((n, n_preds)) < 0.5
    mask = rng.random(n) < 0.8 if masked else np.ones(n, bool)
    args = (jnp.asarray(path_id), jnp.asarray(y), jnp.asarray(bmat),
            jnp.asarray(mask), n_paths, n_preds, n_class)
    got = tt._path_pred_class_count_local(
        _t(path_id), _t(y), _t(bmat), _t(mask) if masked else None,
        n_paths, n_preds, n_class).numpy()
    for mxu in (True, False):
        want = np.asarray(jt._path_pred_class_count_local(*args,
                                                          force_mxu=mxu))
        np.testing.assert_array_equal(got, want)

    n_splits, max_seg = 6, 4
    seg = rng.integers(-1, max_seg + 1, (n, n_splits)).astype(np.int32)
    sargs = (jnp.asarray(seg), jnp.asarray(y), jnp.asarray(mask),
             n_splits, max_seg, n_class)
    got = tt._seg_class_count_local(_t(seg), _t(y),
                                    _t(mask) if masked else None,
                                    n_splits, max_seg, n_class).numpy()
    for mxu in (True, False):
        want = np.asarray(jt._seg_class_count_local(*sargs, force_mxu=mxu))
        np.testing.assert_array_equal(got, want)
    got = tt._class_count_local(_t(y), _t(mask) if masked else None,
                                n_class).numpy()
    want = np.asarray(jt._class_count_local(jnp.asarray(y), jnp.asarray(mask),
                                            n_class))
    np.testing.assert_array_equal(got, want)


def test_streamed_fold_adds_into_its_carry():
    rng = np.random.default_rng(3)
    path_id = rng.integers(0, 4, 300).astype(np.int32)
    y = rng.integers(0, 2, 300).astype(np.int32)
    bmat = rng.random((300, 5)) < 0.4
    whole = tt._path_pred_class_count_local(_t(path_id), _t(y), _t(bmat),
                                            None, 4, 5, 2)
    carry = None
    for lo in range(0, 300, 70):
        sl = slice(lo, lo + 70)
        carry = tt._path_pred_class_count_local(
            _t(path_id[sl]), _t(y[sl]), _t(bmat[sl]), None, 4, 5, 2,
            out=carry)
    assert torch.equal(carry, whole)


# ---------------------------------------------------------------------------
# the level pass: streamed, on a mesh, carried across packages
# ---------------------------------------------------------------------------

def _dtb_props(tmp, **over):
    props = {"feature.schema.file.path": SCHEMA,
             "decision.file.path": str(tmp / "decpath.json"),
             "split.algorithm": "entropy",
             "path.stopping.strategy": "maxDepth", "max.depth.limit": "2",
             "sub.sampling.strategy": "none", "seed": "11"}
    props.update(over)
    return props


@pytest.fixture(scope="module")
def reference_levels(tmp_path_factory, mesh8):
    """The reference's three levels over retarget 200 (seed 5): each
    level's decision file and records."""
    tmp = tmp_path_factory.mktemp("torch_tree_levels")
    rows = [",".join(r) for r in gen_retarget(200, seed=5)]
    write_output(str(tmp / "in"), rows)
    job = jt.DecisionTreeBuilder(JaxConfig(_dtb_props(tmp)))
    src, out = str(tmp / "in"), {}
    for lvl in range(3):
        dst = str(tmp / f"ref{lvl}")
        job.run(src, dst, mesh=mesh8)
        out[lvl] = ((tmp / "decpath.json").read_bytes(), _read(dst))
        src = dst
    return tmp, out


def _port_levels(tmp, tag, start, mesh=None, **over):
    """The port's levels from ``start`` (the reference's decision file and
    records of level ``start - 1`` when ``start`` > 0)."""
    dec = tmp / f"{tag}.json"
    job = tt.DecisionTreeBuilder(JobConfig(_dtb_props(
        tmp, **{"decision.file.path": str(dec)}, **over)), device="cpu")
    if start:
        shutil.copy(tmp / f"ref{start - 1}.json", dec)
    src = str(tmp / ("in" if start == 0 else f"ref{start - 1}"))
    out = {}
    for lvl in range(start, 3):
        dst = str(tmp / f"{tag}{lvl}")
        job.run(src, dst, mesh=mesh)
        out[lvl] = (dec.read_bytes(), _read(dst))
        src = dst
    return out


@pytest.mark.parametrize("mode", ["one", "mesh8", "streamed", "stream-tiny"])
def test_levels_match_reference(reference_levels, mode):
    tmp, want = reference_levels
    for lvl, (dec, _) in want.items():
        (tmp / f"ref{lvl}.json").write_bytes(dec)
    over = {"streamed": {"pipeline.chunk.rows": "4000"},
            "stream-tiny": {"pipeline.chunk.rows": "333"}}.get(mode, {})
    got = _port_levels(tmp, mode, 0,
                       mesh=MESH8 if mode == "mesh8" else None, **over)
    assert got == want


@pytest.mark.parametrize("start", [1, 2])
def test_tree_carried_across_packages(reference_levels, start):
    """The port grows a tree the reference began (its decision file and
    records), and the reference grows one the port began: the bytes of an
    all-reference run."""
    tmp, want = reference_levels
    for lvl, (dec, _) in want.items():
        (tmp / f"ref{lvl}.json").write_bytes(dec)
    got = _port_levels(tmp, f"carry{start}", start)
    assert got == {k: v for k, v in want.items() if k >= start}
    # the other way: the port's first levels, the reference's last
    port = _port_levels(tmp, f"back{start}", 0)
    dec = tmp / f"back{start}_ref.json"
    dec.write_bytes(port[start - 1][0])
    job = jt.DecisionTreeBuilder(JaxConfig(_dtb_props(
        tmp, **{"decision.file.path": str(dec)})))
    job.run(str(tmp / f"back{start}{start - 1}"), str(tmp / f"rb{start}"))
    assert (dec.read_bytes(), _read(tmp / f"rb{start}")) == want[start]


def test_streamed_level_refuses_a_mesh(reference_levels, monkeypatch):
    """The streamed level pass on a mesh (the name is kept from when the
    port refused one): pass 1's count folds 100-row chunks over the 8
    positions (and 4 x 2), and every level's decision file and records
    equal the reference's on ``mesh8``."""
    from avenir_tpu_torch.ops import counting

    tmp, want = reference_levels
    for lvl, (dec, _) in want.items():
        (tmp / f"ref{lvl}.json").write_bytes(dec)
    folds = []
    resident = counting.sharded_reduce_resident

    def spy(*a, **kw):
        folds.append(kw["mesh"].size)
        return resident(*a, **kw)
    monkeypatch.setattr(counting, "sharded_reduce_resident", spy)
    for shape in ((8, 1), (4, 2)):
        pm = pmesh.make_mesh([CPU] * 8, data=shape[0], model=shape[1])
        got = _port_levels(tmp, f"smesh{shape[0]}", 0, mesh=pm,
                           **{"pipeline.chunk.rows": "100"})
        assert got == want, shape
    assert folds and set(folds) == {8}


@pytest.mark.parametrize("over", [
    {"split.attribute.selection.strategy": "randomAll",
     "random.split.set.size": "1", "pipeline.chunk.rows": "3000"},
    {"sub.sampling.strategy": "withReplace",
     "sub.sampling.buffer.size": "40", "split.algorithm": "giniIndex",
     "path.stopping.strategy": "minPopulation",
     "min.population.limit": "4000"},
], ids=["randomAll-streamed", "bootstrap-gini-minPopulation"])
def test_run_loop_matches_reference(tmp_path, mesh8, over):
    rows = [",".join(r) for r in gen_retarget(150, seed=8)]
    write_output(str(tmp_path / "in"), rows)
    dec = {}
    for name, mod, cfg, kw in (("j", jt, JaxConfig, {"mesh": mesh8}),
                               ("p", tt, JobConfig, {})):
        props = _dtb_props(tmp_path, **over)
        props["decision.file.path"] = str(tmp_path / f"{name}.json")
        job = (mod.DecisionTreeBuilder(cfg(props)) if name == "j" else
               mod.DecisionTreeBuilder(cfg(props), device="cpu"))
        dpl = job.run_loop(str(tmp_path / "in"), str(tmp_path / f"{name}w"),
                           max_levels=4, **kw)
        dec[name] = (tmp_path / f"{name}.json").read_bytes()
        assert dpl.all_stopped()
    assert dec["p"] == dec["j"]
    for lvl in range(4):
        j, p = tmp_path / "jw" / f"level_{lvl}", tmp_path / "pw" / f"level_{lvl}"
        assert os.path.isdir(j) == os.path.isdir(p)
        if os.path.isdir(j):
            assert _read(p) == _read(j)


# ---------------------------------------------------------------------------
# candidate splits and the partitioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    {"at.root": "true", "split.algorithm": "entropy"},
    {"split.attribute.selection.strategy": "all", "parent.info": "0.93",
     "split.algorithm": "entropy", "output.split.prob": "true"},
    {"split.attribute.selection.strategy": "random",
     "random.split.set.size": "1", "seed": "4", "parent.info": "0.4"},
    {"split.attributes": "2", "split.algorithm": "hellingerDistance"},
    {"split.attributes": "1,2", "split.algorithm": "classConfidenceRatio"},
], ids=["at-root", "all-prob", "random", "hellinger", "confidence"])
def test_class_partition_generator_matches_reference(tmp_path, mesh8, over):
    rows = [",".join(r) for r in gen_retarget(1200, seed=2)]
    write_output(str(tmp_path / "in"), rows)
    props = dict({"feature.schema.file.path": SCHEMA}, **over)
    jt.ClassPartitionGenerator(JaxConfig(dict(props))).run(
        str(tmp_path / "in"), str(tmp_path / "j"), mesh=mesh8)
    for name, m in (("p", None), ("pm", MESH8)):
        counters = tt.ClassPartitionGenerator(
            JobConfig(dict(props)), device="cpu").run(
            str(tmp_path / "in"), str(tmp_path / name), mesh=m)
        assert _read(tmp_path / name) == _read(tmp_path / "j")
    assert counters.get("Basic", "Records") == 1200


@pytest.mark.parametrize("seed", ["3", "12"])
def test_data_partitioner_random_from_top(tmp_path, seed):
    """``randomFromTop`` picks with ``random.Random(seed)``: the same
    candidate and the same segment files as the reference."""
    out = {}
    for name, mod, cfg, kw in (("jax", jt, JaxConfig, {}),
                               ("port", tt, JobConfig, {"device": "cpu"})):
        base = tmp_path / name
        node = base / "split=root" / "data"
        os.makedirs(node)
        rows = [",".join(r) for r in gen_retarget(300, seed=6)]
        (node / "partition.txt").write_text("\n".join(rows) + "\n")
        os.makedirs(base / "split=root" / "splits")
        (base / "split=root" / "splits" / "part-r-00000").write_text(
            "2;120;0.9\n2;120:220;0.5\n1;[1C, 1S]:[1N, 2C, 2S, 2N, 3C, 3S, "
            "3N];0.7\n1;[1C]:[1S, 1N, 2C, 2S, 2N, 3C, 3S, 3N];0.3\n")
        mod.DataPartitioner(cfg({
            "feature.schema.file.path": SCHEMA,
            "project.base.path": str(base),
            "split.selection.strategy": "randomFromTop",
            "num.top.splits": "3", "seed": seed}), **kw).run()
        out[name] = _tree_files(node)
    assert out["port"] == out["jax"]
    assert len(out["port"]) > 1


@pytest.mark.parametrize("gains_by", ["jax", "port"])
def test_candidate_splits_carried_across_packages(tmp_path, gains_by):
    """The candidate-gain file one package's ``SplitGenerator`` writes,
    partitioned by the other package's ``DataPartitioner``: the split
    directories of an all-reference run."""
    rows = [",".join(r) for r in gen_retarget(600, seed=9)]
    out = {}
    for name in ("ref", "carry"):
        base = tmp_path / name
        node = base / "split=root" / "data"
        os.makedirs(node)
        (node / "partition.txt").write_text("\n".join(rows) + "\n")
        gen = {"feature.schema.file.path": SCHEMA, "field.delim.out": ";",
               "project.base.path": str(base), "split.attributes": "1,2",
               "split.algorithm": "giniIndex", "parent.info": "0.45"}
        part = {"feature.schema.file.path": SCHEMA,
                "project.base.path": str(base)}
        first = "jax" if name == "ref" else gains_by
        second = "jax" if name == "ref" else {"jax": "port",
                                              "port": "jax"}[gains_by]
        for who, job, props in ((first, "SplitGenerator", gen),
                                (second, "DataPartitioner", part)):
            if who == "jax":
                getattr(jt, job)(JaxConfig(dict(props))).run()
            else:
                getattr(tt, job)(JobConfig(dict(props)), device="cpu").run()
        out[name] = _tree_files(base)
    assert out["carry"] == out["ref"]
    assert any("segment=1" in k for k in out["ref"])
