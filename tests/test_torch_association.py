"""The port's Apriori pipeline (``avenir_tpu_torch/models/association.py``)
held against the JAX package's on the CPU.

Every case of tests/test_association.py runs through both packages on
the same seeded transactions (``avenir_tpu.datagen``), the reference on
its 8-device CPU mesh and the port on one CPU device and on a mesh that
names the CPU eight times; the output files must be byte-identical.  The
``resource/freq_items/run.sh`` sequence runs through both command lines;
the streamed support (``pipeline.chunk.rows``) must equal the resident
one; the float32 support product must equal an int64 count.
"""

import contextlib
import io
import os
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.datagen import gen_transactions
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import association as ja

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import association as ta
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNBOOK = os.path.join(REPO, "resource", "freq_items")
CPU = torch.device("cpu")
MESHES = ["cpu", "cpu-mesh8"]


def _port_mesh(name):
    return None if name == "cpu" else pmesh.make_mesh([CPU] * 8)


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _lines(path):
    return _read(path).decode().splitlines()


@pytest.fixture(scope="module")
def trans(tmp_path_factory):
    """tests/test_association.py's input: 400 transactions over 60 items,
    the triple (3, 7, 11) planted at support 0.5, seed 17."""
    tmp = tmp_path_factory.mktemp("torch_apriori")
    rows = gen_transactions(400, 60, planted=((3, 7, 11),),
                            planted_support=0.5, seed=17)
    write_output(str(tmp / "trans"), [",".join(r) for r in rows])
    base = {"fia.skip.field.count": "1", "fia.tans.id.ord": "0",
            "fia.support.threshold": "0.1", "fia.total.tans.count": "400",
            "fia.emit.trans.id": "false"}
    return tmp, rows, base


def _pass_both(tmp, props, k, in_name, out_name, mesh8, port_mesh):
    """One pass through each package; returns both outputs' bytes."""
    props = dict(props)
    props["fia.item.set.length"] = str(k)
    out = {}
    for side in ("jax", "port"):
        p = dict(props)
        if k > 1:
            p["fia.item.set.file.path"] = str(tmp / f"{side}_{out_name[:-1]}"
                                              f"{k - 1}")
        dst = str(tmp / f"{side}_{out_name}")
        if side == "jax":
            ja.FrequentItemsApriori(JaxConfig(p)).run(
                str(tmp / in_name), dst, mesh=mesh8)
        else:
            ta.FrequentItemsApriori(JobConfig(p), device="cpu").run(
                str(tmp / in_name), dst, mesh=port_mesh)
        out[side] = _read(dst)
    return out["jax"], out["port"]


@pytest.mark.parametrize("mesh", MESHES)
def test_apriori_k1_counts(trans, mesh8, mesh):
    tmp, rows, base = trans
    want, got = _pass_both(tmp, base, 1, "trans", f"c{mesh}1", mesh8,
                           _port_mesh(mesh))
    assert got == want
    counts = {l.split(",")[0]: int(l.split(",")[1])
              for l in got.decode().splitlines()}
    tok = Counter(it for r in rows for it in r[1:])
    for item in ("I00003", "I00007", "I00011"):
        assert counts[item] > 180
    assert all(counts[it] == tok[it] for it in counts)


@pytest.mark.parametrize("mesh", MESHES)
def test_apriori_k2_k3_planted_recovery(trans, mesh8, mesh):
    tmp, rows, base = trans
    pm = _port_mesh(mesh)
    for k in (1, 2, 3):
        want, got = _pass_both(tmp, base, k, "trans", f"p{mesh}{k}", mesh8,
                               pm)
        assert got == want, k
    got3 = {tuple(l.split(",")[:3]) for l in got.decode().splitlines()}
    assert ("I00003", "I00007", "I00011") in got3


@pytest.mark.parametrize("mesh", MESHES)
def test_apriori_trans_id_mode(trans, mesh8, mesh):
    tmp, rows, base = trans
    props = dict(base, **{"fia.emit.trans.id": "true",
                          "fia.trans.id.output": "true"})
    pm = _port_mesh(mesh)
    for k in (1, 2, 3):
        want, got = _pass_both(tmp, props, k, "trans", f"t{mesh}{k}", mesh8,
                               pm)
        assert got == want, k
    line = next(l for l in _lines(tmp / f"port_t{mesh}2")
                if l.startswith("I00003,I00007,"))
    tids = set(line.split(",")[2:-1])
    for r in rows:
        assert (r[0] in tids) == ({"I00003", "I00007"} <= set(r[1:]))


def test_rule_miner(tmp_path):
    write_output(str(tmp_path / "freq"), ["a,0.5", "b,0.4", "a,b,0.35"])
    props = {"arm.conf.threshold": "0.75", "arm.max.ante.size": "2"}
    ja.AssociationRuleMiner(JaxConfig(props)).run(str(tmp_path / "freq"),
                                                  str(tmp_path / "jax"))
    c = ta.AssociationRuleMiner(JobConfig(props), device="cpu").run(
        str(tmp_path / "freq"), str(tmp_path / "port"))
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    assert _lines(tmp_path / "port") == ["b -> a"]
    assert c.get("Rules", "Emitted") == 1


def test_infrequent_item_marker(tmp_path):
    write_output(str(tmp_path / "freq1"), ["a,0.5", "b,0.4"])
    write_output(str(tmp_path / "trans"), ["T1,a,z,b", "T2,q,a"])
    props = {"iim.item.set.length": "1",
             "iim.item.set.file.path": str(tmp_path / "freq1"),
             "iim.contains.trans.id": "false"}
    ja.InfrequentItemMarker(JaxConfig(props)).run(str(tmp_path / "trans"),
                                                  str(tmp_path / "jax"))
    c = ta.InfrequentItemMarker(JobConfig(props), device="cpu").run(
        str(tmp_path / "trans"), str(tmp_path / "port"))
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    assert _lines(tmp_path / "port") == ["T1,a,*,b", "T2,*,a"]
    assert c.get("Marker", "Masked") == 2


def test_itemset_list_loader(tmp_path):
    write_output(str(tmp_path / "sets"), ["a,b,T1,T2,0.5", "c,d,T3,0.25"])
    for isl in (ta.ItemSetList(str(tmp_path / "sets"), 2, True),
                ja.ItemSetList(str(tmp_path / "sets"), 2, True)):
        s = isl.get_item_set_list()[0]
        assert s.items == ["a", "b"] and s.transaction_ids == ["T1", "T2"]
        assert s.contains_trans("T1") and not s.contains_trans("T3")


@pytest.mark.parametrize("mesh", MESHES)
def test_distinct_mode_dedupes_transaction_ids(tmp_path, mesh8, mesh):
    write_output(str(tmp_path / "trans"), ["T1,A,B", "T1,A,B", "T2,A,B",
                                           "T3,C"])
    base = {"fia.skip.field.count": "1", "fia.tans.id.ord": "0",
            "fia.support.threshold": "0.1", "fia.total.tans.count": "3"}
    pm = _port_mesh(mesh)
    got = {}
    for mode in ("true", "false"):
        props = dict(base, **{"fia.emit.trans.id": mode})
        for k in (1, 2):
            want, got[mode, k] = _pass_both(tmp_path, props, k, "trans",
                                            f"d{mode}{k}", mesh8, pm)
            assert got[mode, k] == want
    assert b"A,T1,T2,0.667" in got["true", 1].splitlines()
    assert b"A,B,T1,T2,0.667" in got["true", 2].splitlines()
    assert b"A,3,1.000" in got["false", 1].splitlines()
    assert b"A,B,6,2.000" in got["false", 2].splitlines()


# ---------------------------------------------------------------------------
# the runbook, the streamed path and the support product
# ---------------------------------------------------------------------------

def _run_quiet(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(list(argv))
    assert rc in (0, None), err.getvalue()


def _freq_items_runbook(work, main, dg, extra=()):
    """resource/freq_items/run.sh's steps through ``main`` (a package's
    command line) with the working directory at the runbook's layout."""
    os.makedirs(os.path.join(work, "work", "freq_all"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert dg(["timed_transactions", "500", "60", "--seed", "37",
                   "--out", "work/raw/part-00000"]) == 0

        def job(*argv):
            _run_quiet(main, list(argv) + list(extra))

        job("TemporalFilter", f"-Dconf.path={RUNBOOK}/tef.properties",
            "work/raw", "work/trans")
        with open("work/trans/part-r-00000") as fh:
            n = sum(1 for _ in fh)
        for k in (1, 2, 3):
            prev = [f"-Dfia.item.set.file.path=work/k{k - 1}"] if k > 1 else []
            for form, more in (("", []), ("f", ["-Dfia.trans.id.output=false"])):
                job("FrequentItemsApriori",
                    f"-Dconf.path={RUNBOOK}/fia.properties",
                    f"-Dfia.item.set.length={k}",
                    f"-Dfia.total.tans.count={n}", *more, *prev,
                    "work/trans", f"work/k{k}{form}")
            shutil.copy(f"work/k{k}f/part-r-00000", f"work/freq_all/part-{k}")
        job("InfrequentItemMarker", f"-Dconf.path={RUNBOOK}/iim.properties",
            "work/trans", "work/marked")
        job("AssociationRuleMiner", f"-Dconf.path={RUNBOOK}/arm.properties",
            "work/freq_all", "work/rules")
    finally:
        os.chdir(cwd)


RUNBOOK_OUTPUTS = ["trans", "k1", "k1f", "k2", "k2f", "k3", "k3f", "marked",
                   "rules"]


@pytest.fixture(scope="module")
def freq_items(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("freq_items")
    _freq_items_runbook(str(tmp / "jax"), jax_main, jax_datagen)
    _freq_items_runbook(str(tmp / "port"), port_main, datagen.main,
                        extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("name", RUNBOOK_OUTPUTS)
def test_freq_items_runbook_byte_identical(freq_items, name):
    got = _read(freq_items / "port" / "work" / name)
    assert got == _read(freq_items / "jax" / "work" / name)
    assert got                                  # every step wrote lines


@pytest.mark.parametrize("emit_trans_id", ["true", "false"])
@pytest.mark.parametrize("chunk,depth", [(37, 2), (37, 0), (128, 1)])
def test_streamed_support_equals_resident(trans, mesh8, emit_trans_id,
                                          chunk, depth):
    """``pipeline.chunk.rows`` streams incidence row chunks through
    ``streaming_fold`` with the candidates as a broadcast argument: the
    same lines as the resident product and the reference's streamed
    run."""
    tmp, _, base = trans
    props = dict(base, **{"fia.emit.trans.id": emit_trans_id,
                          "fia.trans.id.output": "true"})
    tag = f"s{emit_trans_id}{chunk}_{depth}_"
    for k in (1, 2, 3):
        want_res, got_res = _pass_both(tmp, props, k, "trans", f"{tag}r{k}",
                                       mesh8, None)
        stream = dict(props, **{"pipeline.chunk.rows": str(chunk),
                                "pipeline.prefetch.depth": str(depth)})
        want, got = _pass_both(tmp, stream, k, "trans", f"{tag}s{k}", mesh8,
                               None)
        assert got == want == got_res == want_res, k


def test_streamed_support_refuses_a_mesh(trans):
    tmp, _, base = trans
    for k in (1, 2):
        props = dict(base, **{"fia.item.set.length": str(k),
                              "pipeline.chunk.rows": "50"})
        if k > 1:
            props["fia.item.set.file.path"] = str(tmp / "mref1")
        job = ta.FrequentItemsApriori(JobConfig(props), device="cpu")
        if k == 1:
            job.run(str(tmp / "trans"), str(tmp / "mref1"))
            continue
        with pytest.raises(NotImplementedError, match="one device"):
            job.run(str(tmp / "trans"), str(tmp / "mref2"),
                    mesh=pmesh.make_mesh([CPU] * 2))


@pytest.mark.parametrize("nt,V,n_s,km1", [(300, 17, 40, 1), (5000, 9, 20, 2),
                                          (20000, 6, 12, 3)])
def test_float32_support_equals_int64_count(nt, V, n_s, km1):
    """The support product against an int64 numpy count, at counts past
    what bf16 holds (20,000 rows of all ones): exact in float32 with
    TF32 off, resident and chunk-folded, masked rows dropped."""
    rng = np.random.default_rng(nt)
    inc = (rng.random((nt, V)) < 0.6).astype(np.uint8)
    inc[: nt // 2] = 1
    mask = np.ones(nt, bool)
    mask[rng.integers(0, nt, nt // 10)] = False
    sets = np.stack([rng.choice(V, km1, replace=False) for _ in range(n_s)])
    chunks = ta.FrequentItemsApriori._candidate_chunks(
        sets.astype(np.int32), nt_local=nt, k=km1 + 1)
    want = np.zeros((n_s, V), np.int64)
    m = inc.astype(np.int64) * mask[:, None]
    for s in range(n_s):
        v = np.prod(m[:, sets[s]], axis=1)
        want[s] = v @ m
    got = ta._apriori_support_local(torch.from_numpy(inc),
                                    torch.from_numpy(chunks),
                                    torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[:n_s].astype(np.int64), want)
    folded = None
    for lo in range(0, nt, 4096):
        part = torch.from_numpy(inc[lo:lo + 4096])
        folded = ta._apriori_chunk_support_local(
            part, torch.from_numpy(mask[lo:lo + 4096]),
            torch.from_numpy(chunks), out=folded)
    np.testing.assert_array_equal(folded.numpy()[:n_s].astype(np.int64),
                                  want)
    if nt >= 5000:
        assert want.max() > 256      # beyond bf16's exact integers


def test_candidate_chunks_bound_the_indicator():
    sets = np.arange(3000, dtype=np.int32).reshape(1500, 2)
    c = ta.FrequentItemsApriori._candidate_chunks(sets, nt_local=1_000_000,
                                                  k=3)
    assert c.shape == (6, 268, 2)                 # 2^28 // 1e6 = 268
    assert (c.reshape(-1, 2)[:1500] == sets).all()
    assert (c.reshape(-1, 2)[1500:] == 0).all()
    assert ta.FrequentItemsApriori._candidate_chunks(
        sets[:5], nt_local=10, k=3).shape == (1, 16, 2)   # at least 16


def test_incidence_stays_resident_across_passes(trans):
    """The k = 2 and k = 3 passes over one input share one device
    incidence (uint8), dropped when the encode is let go."""
    tmp, _, base = trans
    ta._inc_device_cache.clear()
    ta._encode_cache.clear()
    props = dict(base, **{"fia.emit.trans.id": "true"})
    for k in (1, 2, 3):
        p = dict(props, **{"fia.item.set.length": str(k)})
        if k > 1:
            p["fia.item.set.file.path"] = str(tmp / f"res{k - 1}")
        ta.FrequentItemsApriori(JobConfig(p), device="cpu").run(
            str(tmp / "trans"), str(tmp / f"res{k}"))
        if k == 2:
            (entry,) = ta._inc_device_cache.values()
            ptr = entry[1][0].data_ptr()
            assert entry[1][0].dtype == torch.uint8
    (entry,) = ta._inc_device_cache.values()
    assert entry[1][0].data_ptr() == ptr
    ta._encode_cache.clear()
    import gc
    gc.collect()
    assert not ta._inc_device_cache


def test_apriori_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.FrequentItemsApriori(JobConfig({}))
