"""The port's shared scan (``avenir_tpu_torch/core/multiscan.py``) held
against the JAX package's on the CPU.

One CSV feeds the five fusable jobs (NB, MI, Cramer, the Markov
trainer, NumericalAttrStats), as in the reference's
``tests/test_multiscan.py``.  The port's fused pass, on its one-device CPU
mesh and on an 8-position ``[cpu] * 8`` mesh at prefetch depths 0 and 2,
must write the port's standalone outputs and the reference's fused
outputs; ``resource/multiscan/run.sh`` runs through both command lines; a
fused pass killed by an injected worker death resumes from its sidecar;
a warm pass reads the tee'd ingest cache; withdrawals, encode and
finalize errors, the spans and the fan-out gauge behave as the
reference's.  Outputs are integer tables and host float64 text, so every
comparison is byte equality.
"""

import contextlib
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from avenir_tpu.cli import _job_resolver as jax_resolver
from avenir_tpu.cli import main as jax_main
from avenir_tpu.core import faultinject as jfi
from avenir_tpu.core import multiscan as jms
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.datagen.cli import main as jax_datagen

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import job_class, job_resolver, resolve
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core import faultinject, multiscan, obs
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.faultinject import FaultInjector, parse_plan
from avenir_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTISCAN = os.path.join(REPO, "resource", "multiscan")
CPU = torch.device("cpu")
MESHES = {1: make_mesh([CPU]), 8: make_mesh([CPU] * 8)}

# id, color, amount, score, label, s1..s4 (trailing Markov states)
NB_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["red", "green", "blue"]},
    {"name": "amount", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "bucketWidth": 7},
    {"name": "score", "ordinal": 3, "dataType": "int", "feature": True},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}
MI_SCHEMA = {"fields": [f for f in NB_SCHEMA["fields"]
                        if f["name"] != "score"]}
STATES = ["A", "B", "C"]
JIDS = ["nb", "mi", "corr", "mst", "stats"]


def _rows(n=467, seed=11, colors=("red", "green", "blue")):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        c = colors[int(rng.integers(len(colors)))]
        amt = int(rng.integers(0, 100))
        score = int(rng.integers(-40, 60))
        lbl = "Y" if (c == "red") ^ (amt > 55) ^ (rng.random() < 0.2) else "N"
        seq = [STATES[int(rng.integers(3))] for _ in range(4)]
        rows.append([f"id{i:05d}", c, str(amt), str(score), lbl] + seq)
    return rows


def _write_workload(d, rows) -> str:
    (d / "nb_schema.json").write_text(json.dumps(NB_SCHEMA))
    (d / "mi_schema.json").write_text(json.dumps(MI_SCHEMA))
    in_dir = d / "in"
    in_dir.mkdir(exist_ok=True)
    (in_dir / "part-00000").write_text(
        "\n".join(",".join(r) for r in rows) + "\n")
    return str(in_dir)


def _job_props(d):
    return {
        "nb": ("BayesianDistribution",
               {"feature.schema.file.path": str(d / "nb_schema.json")}),
        "mi": ("MutualInformation",
               {"feature.schema.file.path": str(d / "mi_schema.json")}),
        "corr": ("CramerCorrelation",
                 {"feature.schema.file.path": str(d / "mi_schema.json"),
                  "source.attributes": "1", "dest.attributes": "4"}),
        "mst": ("MarkovStateTransitionModel",
                {"model.states": ",".join(STATES),
                 "skip.field.count": "5"}),
        "stats": ("NumericalAttrStats",
                  {"attr.list": "2,3", "cond.attr.ord": "4"}),
    }


def _manifest(d, pipe, jids=JIDS, **extra):
    props = dict(pipe, **{"multi.jobs": ",".join(jids)})
    jp = _job_props(d)
    for jid in jids:
        cls, jprops = jp[jid]
        props[f"multi.job.{jid}.class"] = cls
        for k, v in jprops.items():
            props[f"multi.job.{jid}.{k}"] = v
    props.update(extra)
    return props


def _read(path) -> bytes:
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _outputs(base, jids=JIDS) -> dict:
    return {jid: _read(os.path.join(base, jid)) for jid in jids}


def _standalone(d, in_dir, pipe, jid, out):
    cls, props = _job_props(d)[jid]
    job = job_class(cls)(JobConfig(dict(props, **pipe), resolve(cls)[2]),
                         device="cpu")
    job.run(in_dir, str(out))
    return _read(out)


def _fused(props, in_dir, out, mesh=MESHES[1], log=None):
    return multiscan.run_multi(JobConfig(dict(props)), in_dir, str(out),
                               job_resolver("cpu"), mesh=mesh, log=log)


@pytest.fixture(autouse=True)
def _clear_global_state():
    yield
    faultinject.set_injector(None)
    jfi.set_injector(None)
    obs.configure(enabled=False)
    obs.get_tracer().clear()


PIPE = {"pipeline.chunk.rows": "101", "pipeline.prefetch.depth": "2"}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The five-job workload, the port's standalone outputs and the
    reference's fused outputs (on its 8-device mesh)."""
    d = tmp_path_factory.mktemp("torch_multiscan")
    in_dir = _write_workload(d, _rows())
    alone = {jid: _standalone(d, in_dir, PIPE, jid, d / f"alone_{jid}")
             for jid in JIDS}
    jms.run_multi(JaxConfig(_manifest(d, PIPE)), in_dir, str(d / "ref"),
                  jax_resolver)
    return {"dir": d, "in": in_dir, "alone": alone,
            "ref": _outputs(d / "ref")}


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("n_pos", [1, 8])
def test_fused_five_jobs_match_standalone_and_reference(work, tmp_path,
                                                        n_pos, depth):
    pipe = dict(PIPE, **{"pipeline.prefetch.depth": str(depth)})
    msgs = []
    _fused(_manifest(work["dir"], pipe), work["in"], tmp_path / "fused",
           mesh=MESHES[n_pos], log=msgs.append)
    assert not msgs, msgs                  # every job stayed fused
    got = _outputs(tmp_path / "fused")
    assert got == work["alone"]
    assert got == work["ref"]


def test_same_schema_jobs_share_one_encoder_and_one_copy(work, tmp_path):
    """NB and MI on one schema file share one encoder, so each chunk is
    encoded and copied to the device once, and each still writes its
    standalone bytes."""
    d = work["dir"]
    sp = str(d / "mi_schema.json")
    engine = multiscan.MultiScanEngine(device="cpu", chunk_rows=80,
                                       prefetch_depth=2)
    nb = job_class("BayesianDistribution")(
        JobConfig({"feature.schema.file.path": sp}), device="cpu")
    mi = job_class("MutualInformation")(
        JobConfig({"feature.schema.file.path": sp}), device="cpu")
    spec_nb = engine.register(nb.fold_spec(str(tmp_path / "f_nb")))
    spec_mi = engine.register(mi.fold_spec(str(tmp_path / "f_mi")))
    assert spec_nb.enc is spec_mi.enc, "schema encoder not shared"
    results = engine.run(work["in"], ",")
    assert not engine.failures
    assert set(results) == {"BayesianDistribution", "MutualInformation"}
    assert engine.chunks == -(-467 // 80)
    assert engine.h2d_copies == engine.chunks     # one copy a chunk
    pipe = {"pipeline.chunk.rows": "80"}
    for name, spec, job in (("nb", spec_nb, nb), ("mi", spec_mi, mi)):
        job.config = JobConfig({"feature.schema.file.path": sp, **pipe})
        job.run(work["in"], str(tmp_path / f"a_{name}"))
        assert _read(spec.out_path) == _read(tmp_path / f"a_{name}"), name


def _late_colors(tmp_path):
    rows = _rows(300, seed=3)
    # undeclared colors flood in after the first 128-row chunk and
    # overflow the NB and MI bin caps (first-chunk extent + 4)
    late = _rows(120, seed=4, colors=tuple(f"c{i}" for i in range(30)))
    return _write_workload(tmp_path, rows + late)


def test_cap_overflow_falls_back_standalone_and_stays_identical(tmp_path):
    in_dir = _late_colors(tmp_path)
    pipe = {"pipeline.chunk.rows": "128", "pipeline.prefetch.depth": "2"}
    jids = ["nb", "mi", "mst", "stats"]
    msgs = []
    _fused(_manifest(tmp_path, pipe, jids), in_dir, tmp_path / "fused",
           log=msgs.append)
    withdrawn = sorted(m.split("'")[1] for m in msgs if "standalone" in m)
    assert withdrawn == ["mi", "nb"], msgs
    jmsgs = []
    jms.run_multi(JaxConfig(_manifest(tmp_path, pipe, jids)), in_dir,
                  str(tmp_path / "ref"), jax_resolver, log=jmsgs.append)
    assert msgs == jmsgs                       # the reference's log lines
    got = _outputs(tmp_path / "fused", jids)
    assert got == _outputs(tmp_path / "ref", jids)
    for jid in jids:
        assert got[jid] == _standalone(tmp_path, in_dir, pipe, jid,
                                       tmp_path / f"alone_{jid}"), jid


def test_standalone_fallback_on_a_larger_mesh_raises_not_implemented(
        tmp_path, mesh8):
    """A withdrawn job re-runs standalone with the workflow's mesh (the
    name is kept from when the port refused one): on 8 positions NB and MI
    withdraw at the cap overflow and re-run on the mesh, and every output
    equals the reference's workflow on ``mesh8`` and each job run alone on
    one device."""
    in_dir = _late_colors(tmp_path)
    pipe = {"pipeline.chunk.rows": "128", "pipeline.prefetch.depth": "2"}
    jids = ["nb", "mi", "mst", "stats"]
    msgs = []
    _fused(_manifest(tmp_path, pipe, jids), in_dir, tmp_path / "fused",
           mesh=MESHES[8], log=msgs.append)
    withdrawn = sorted(m.split("'")[1] for m in msgs if "standalone" in m)
    assert withdrawn == ["mi", "nb"], msgs
    assert not any("failed" in m for m in msgs), msgs
    jmsgs = []
    jms.run_multi(JaxConfig(_manifest(tmp_path, pipe, jids)), in_dir,
                  str(tmp_path / "ref"), jax_resolver, mesh=mesh8,
                  log=jmsgs.append)
    assert msgs == jmsgs
    got = _outputs(tmp_path / "fused", jids)
    assert got == _outputs(tmp_path / "ref", jids)
    for jid in jids:
        assert got[jid] == _standalone(tmp_path, in_dir, pipe, jid,
                                       tmp_path / f"alone_{jid}"), jid


def test_non_withdrawal_encode_error_spares_healthy_jobs(tmp_path):
    """Markov meeting an undeclared state (KeyError) is withdrawn: NB
    keeps its fused output, and the KeyError surfaces from the
    standalone re-run."""
    rows = _rows(150, seed=21)
    rows[97][5] = "ZZ"
    in_dir = _write_workload(tmp_path, rows)
    pipe = {"pipeline.chunk.rows": "64", "pipeline.prefetch.depth": "2"}
    msgs = []
    with pytest.raises(KeyError, match="ZZ"):
        _fused(_manifest(tmp_path, pipe, ["nb", "mst"]), in_dir,
               tmp_path / "f", log=msgs.append)
    assert any("mst" in m and "standalone" in m for m in msgs), msgs
    assert _read(tmp_path / "f" / "nb") == _standalone(
        tmp_path, in_dir, pipe, "nb", tmp_path / "alone_nb")


def test_finalize_error_spares_other_jobs(tmp_path):
    in_dir = _write_workload(tmp_path, _rows(120, seed=23))
    (tmp_path / "blocker").write_text("not a directory\n")
    pipe = {"pipeline.chunk.rows": "64", "pipeline.prefetch.depth": "2"}
    props = _manifest(tmp_path, pipe, ["nb", "stats"], **{
        "multi.job.nb.output.path": str(tmp_path / "blocker" / "nb")})
    msgs = []
    with pytest.raises(OSError):
        _fused(props, in_dir, tmp_path / "f", log=msgs.append)
    assert any("finalize failed" in m for m in msgs), msgs
    assert os.path.exists(tmp_path / "f" / "stats" / "part-r-00000")


def test_manifest_validation():
    resolver = job_resolver("cpu")
    cfg = JobConfig({"multi.jobs": "a,a",
                     "multi.job.a.class": "BayesianDistribution"})
    with pytest.raises(SystemExit, match="duplicate"):
        multiscan.load_manifest(cfg, "/tmp/x", resolver)
    cfg = JobConfig({"multi.jobs": "a",
                     "multi.job.a.class": "NumericalAttrStats",
                     "multi.job.a.attr.list": "1",
                     "multi.job.a.field.delim.regex": ";"})
    with pytest.raises(SystemExit, match="delim"):
        multiscan.load_manifest(cfg, "/tmp/x", resolver)


def test_merge_carries_adds_tables_dicts_and_tuples():
    a = {"fc": np.arange(4), "pc": (np.ones(2), torch.ones(3))}
    b = {"fc": np.arange(4), "pc": (np.ones(2), torch.ones(3))}
    m = multiscan.merge_carries(a, b)
    np.testing.assert_array_equal(m["fc"], 2 * np.arange(4))
    assert isinstance(m["pc"], tuple)
    np.testing.assert_array_equal(m["pc"][0], [2, 2])
    assert torch.equal(m["pc"][1], torch.full((3,), 2.0))


# ---------------------------------------------------------------------------
# the command line: the runbook, kill and resume, the warm pass
# ---------------------------------------------------------------------------

def _quiet(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def _multiscan_runbook(work_dir, main, dg, extra=()):
    """resource/multiscan/run.sh, from the runbook's directory (its
    manifest names the schema by a relative path)."""
    cwd = os.getcwd()
    os.chdir(MULTISCAN)
    try:
        assert dg(["telecom_churn", "20000", "--seed", "31",
                   "--out", f"{work_dir}/in/part-00000"]) == 0
        rc, err = _quiet(main, ["multi", "-Dconf.path=workflow.properties",
                                f"{work_dir}/in", f"{work_dir}/out"]
                         + list(extra))
        assert rc == 0, err
    finally:
        os.chdir(cwd)
    return err


@pytest.fixture(scope="module")
def runbook(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multiscan_runbook")
    _multiscan_runbook(str(tmp / "jax"), jax_main, jax_datagen)
    err = _multiscan_runbook(str(tmp / "port"), port_main, datagen.main,
                             extra=("--device", "cpu"))
    return tmp, err


@pytest.mark.parametrize("jid", ["nb", "mi", "corr", "stats"])
def test_multiscan_runbook_matches_reference(runbook, jid):
    tmp, err = runbook
    got = _read(tmp / "port" / "out" / jid)
    assert got == _read(tmp / "jax" / "out" / jid)
    assert got
    assert f"--- job {jid}" in err and "standalone" not in err


@pytest.mark.parametrize("depth", [0, 2])
def test_killed_fused_pass_resumes_to_the_clean_bytes(work, tmp_path, depth):
    """A fused pass checkpointed every chunk dies with its prefetch worker
    (``worker_death@3``; an ``h2d`` fault inside the shared scan withdraws
    one job instead, as in the reference); ``--resume`` continues from the
    sidecar, whose carries include MI's dict, and every output equals the
    clean run's, the reference's fused bytes."""
    d = work["dir"]
    base = [f"-D{k}={v}" for k, v in _manifest(d, dict(
        PIPE, **{"pipeline.prefetch.depth": str(depth),
                 "checkpoint.interval.chunks": "1"})).items()]
    out = str(tmp_path / "out")
    conf = tmp_path / "empty.properties"
    conf.write_text("")
    argv = ["multi", f"-Dconf.path={conf}"] + base + [work["in"], out,
                                                      "--device", "cpu"]
    with pytest.raises((RuntimeError, faultinject.SimulatedWorkerDeath)):
        _quiet(port_main, argv + ["-Dfault.inject.plan=worker_death@3"])
    ckpt = os.path.join(out, "_multiscan.ckpt")
    with open(ckpt, "rb") as fh:
        payload = pickle.load(fh)
    assert 0 <= payload["chunk_index"] < 3
    carry = payload["carry"]
    assert set(carry) == {"nb", "mi", "corr", "mst"}   # stats is host-only
    assert set(carry["mi"]) == {"fc", "pc"}
    assert all(isinstance(t, np.ndarray) for t in carry["mi"].values())
    rc, err = _quiet(port_main, argv + ["--resume"])
    assert rc == 0, err
    assert f"at chunk {payload['chunk_index']}" in err
    assert "standalone" not in err
    assert _outputs(out) == work["ref"]
    assert not os.path.exists(ckpt)


def test_h2d_fault_withdraws_the_reference_job(work, tmp_path):
    """``h2d@3`` inside the shared scan withdraws the job whose copy
    failed (the reference's engine treats any per-spec encode or
    transfer failure so); the same job as the reference's re-runs
    standalone and every output still equals the clean bytes."""
    props = _manifest(work["dir"], PIPE, ["nb", "mi", "corr", "stats"])
    faultinject.set_injector(FaultInjector(parse_plan("h2d@3")))
    msgs = []
    _fused(props, work["in"], tmp_path / "port", log=msgs.append)
    faultinject.set_injector(None)
    jfi.set_injector(jfi.FaultInjector(jfi.parse_plan("h2d@3")))
    jmsgs = []
    jms.run_multi(JaxConfig(dict(props)), work["in"], str(tmp_path / "ref"),
                  jax_resolver, log=jmsgs.append)
    jfi.set_injector(None)
    withdrawn = [m.split("'")[1] for m in msgs]
    assert len(withdrawn) == 1 and "standalone" in msgs[0], msgs
    assert withdrawn == [m.split("'")[1] for m in jmsgs]
    got = _outputs(tmp_path / "port", ["nb", "mi", "corr", "stats"])
    assert got == {j: work["ref"][j] for j in got}


def test_warm_fused_pass_reads_the_teed_cache(work, tmp_path):
    """With the ingest cache on, the cold fused pass tees the shared
    encoder's chunks into an artifact, and the warm pass replays them
    (``ingest.cache.read`` spans, no native encode) with the same bytes."""
    from avenir_tpu_torch import native

    props = _manifest(work["dir"], PIPE, ["nb", "mi", "stats"], **{
        "ingest.cache.enable": "true",
        "ingest.cache.dir": str(tmp_path / "cache")})
    _fused(props, work["in"], tmp_path / "cold")
    assert len(os.listdir(tmp_path / "cache")) == 2     # one per schema
    tr = obs.configure(enabled=True)
    tr.clear()
    native.reset_call_counts()
    _fused(props, work["in"], tmp_path / "warm")
    assert native.ENCODE_CALLS == 0
    assert len(tr.spans("ingest.cache.read")) == 2 * -(-467 // 101)
    for jid in ("nb", "mi", "stats"):
        assert _read(tmp_path / "warm" / jid) == work["ref"][jid], jid
        assert _read(tmp_path / "cold" / jid) == work["ref"][jid], jid


def test_multi_cli_and_profile_dir(work, tmp_path):
    """``multi`` and a single job through the command line, each with
    ``--profile-dir``: the fused NB model equals the standalone one, and
    each run writes a torch.profiler trace."""
    d = work["dir"]
    manifest = ["multi.jobs=nb,stats",
                "multi.job.nb.class=BayesianDistribution",
                f"multi.job.nb.conf.path={d}/nb.properties",
                "multi.job.stats.class=org.chombo.mr.NumericalAttrStats",
                "multi.job.stats.attr.list=2,3",
                "multi.job.stats.cond.attr.ord=4",
                "pipeline.chunk.rows=96"]
    (tmp_path / "multi.properties").write_text("\n".join(manifest) + "\n")
    (d / "nb.properties").write_text(
        f"feature.schema.file.path={d}/nb_schema.json\n")
    rc, err = _quiet(port_main, [
        "multi", f"-Dconf.path={tmp_path}/multi.properties", work["in"],
        str(tmp_path / "out"), "--device", "cpu",
        f"--profile-dir={tmp_path}/prof_multi"])
    assert rc == 0, err
    assert "--- job nb" in err and "--- job stats" in err
    rc, err = _quiet(port_main, [
        "BayesianDistribution", f"-Dconf.path={d}/nb.properties",
        "-Dpipeline.chunk.rows=96", work["in"], str(tmp_path / "alone_nb"),
        "--device", "cpu", f"--profile-dir={tmp_path}/prof_job"])
    assert rc == 0, err
    assert _read(tmp_path / "out" / "nb") == _read(tmp_path / "alone_nb")
    for sub in ("prof_multi", "prof_job"):
        traces = os.listdir(tmp_path / sub)
        assert len(traces) == 1 and traces[0].endswith(".json")
        with open(tmp_path / sub / traces[0]) as fh:
            assert json.load(fh)["traceEvents"]
    with pytest.raises(SystemExit, match="profile-dir"):
        port_main(["BayesianDistribution", "--profile-dir", "x", "in",
                   "out", "--device", "cpu"])


def test_multi_needs_a_card_unless_asked_for_the_cpu(work, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _quiet(port_main, ["multi", "-Dmulti.jobs=stats",
                           "-Dmulti.job.stats.class=NumericalAttrStats",
                           "-Dmulti.job.stats.attr.list=2", work["in"],
                           str(tmp_path / "out")])


def test_multiscan_spans_and_fanout_gauge(work, tmp_path):
    d = work["dir"]
    tr = obs.configure(enabled=True)
    tr.clear()
    engine = multiscan.MultiScanEngine(device="cpu", chunk_rows=64,
                                       prefetch_depth=2)
    engine.register(job_class("BayesianDistribution")(JobConfig(
        {"feature.schema.file.path": str(d / "nb_schema.json")}),
        device="cpu").fold_spec(str(tmp_path / "o_nb")))
    engine.register(job_class("NumericalAttrStats")(JobConfig(
        {"attr.list": "2", "cond.attr.ord": "4"}),
        device="cpu").fold_spec(str(tmp_path / "o_stats")))
    engine.run(work["in"], ",")
    enc_jobs = {s.attrs.get("job") for s in tr.spans("multiscan.encode")}
    assert enc_jobs == {"BayesianDistribution", "NumericalAttrStats"}
    fold_jobs = {s.attrs.get("job") for s in tr.spans("multiscan.fold")}
    assert fold_jobs == {"BayesianDistribution"}      # stats is host-only
    widths = [g.value for g in tr.records()
              if isinstance(g, obs.Gauge)
              and g.name == "multiscan.fanout.width"]
    assert widths and max(widths) == 2.0
    assert tr.span_summary("multiscan.fold")["count"] == -(-467 // 64)
    fins = {s.attrs.get("job") for s in tr.spans("multiscan.finalize")}
    assert fins == {"BayesianDistribution", "NumericalAttrStats"}


def test_fold_specs_construct_and_pickle_without_tensors(work, tmp_path):
    """Every port exporter builds a FoldSpec (text-mode NB declines), and
    a spec that has folded pickles (a resume sidecar holds it) with no
    tensor inside."""
    d = work["dir"]
    engine = multiscan.MultiScanEngine(device="cpu", chunk_rows=200,
                                       prefetch_depth=0)
    for jid, (cls, props) in _job_props(d).items():
        job = job_class(cls)(JobConfig(props, resolve(cls)[2]),
                             device="cpu")
        spec = engine.register(job.fold_spec(str(tmp_path / jid)))
        assert isinstance(spec, multiscan.FoldSpec), cls
    engine.run(work["in"], ",")
    for spec in engine.specs:
        blob = pickle.dumps(spec)
        assert b"torch._utils" not in blob and b"_rebuild_tensor" not in blob
        pickle.loads(blob)
    nb_text = job_class("BayesianDistribution")(
        JobConfig({"tabular.input": "false"}), device="cpu")
    assert nb_text.fold_spec(str(tmp_path / "t")) is None


def test_fold_span_per_job_per_chunk(work, tmp_path):
    """A traced fused pass of ``resource/multiscan``'s four jobs records
    one ``multiscan.encode`` span a job a chunk and one ``multiscan.fold``
    span a job with a device fold a chunk (the stats job is host-only)."""
    jids = ["nb", "mi", "corr", "stats"]
    tr = obs.configure(enabled=True)
    tr.clear()
    _fused(_manifest(work["dir"], PIPE, jids), work["in"], tmp_path / "f")
    chunks = -(-467 // int(PIPE["pipeline.chunk.rows"]))
    for name, want in (("multiscan.encode", dict.fromkeys(jids, chunks)),
                       ("multiscan.fold", {"nb": chunks, "mi": chunks,
                                           "corr": chunks})):
        got = {}
        for s in tr.spans(name):
            got[s.attrs["job"]] = got.get(s.attrs["job"], 0) + 1
        assert got == want, name


@pytest.mark.parametrize("late,reruns", [(None, 0), ("purple", 1)])
def test_standalone_reruns_counter(tmp_path, late, reruns):
    """``STANDALONE_RERUNS`` rises once for a job that withdraws
    mid-stream (Cramer meeting a color outside its declared cardinality
    in a later chunk, whose standalone re-run raises its KeyError) and
    stays where it was on a clean pass."""
    rows = _rows(150, seed=29)
    if late is not None:
        rows[120][1] = late
    in_dir = _write_workload(tmp_path, rows)
    pipe = {"pipeline.chunk.rows": "64", "pipeline.prefetch.depth": "2"}
    props = _manifest(tmp_path, pipe, ["corr", "stats"])
    before = multiscan.STANDALONE_RERUNS
    msgs = []
    with (pytest.raises(KeyError, match=late) if late
          else contextlib.nullcontext()):
        _fused(props, in_dir, tmp_path / "f", log=msgs.append)
    assert multiscan.STANDALONE_RERUNS - before == reruns, msgs
    assert [m.split("'")[1] for m in msgs if "running standalone" in m] == \
        (["corr"] if late else [])
