"""The port's workflow DAG (``avenir_tpu_torch/core/dag.py``) held against
the JAX package's on the CPU.

Mirrors ``tests/test_dag.py``: manifest validation (the same error
fragment from both packages), the cost model's four unit cases, the
canonical bin -> {NB, MI, Cramer} -> select -> retrain -> validate ->
publish pipeline (byte-equal to the reference's DAG and to the port's
standalone chain with file handoff), the in-memory handoff and the
optional sink with the reference's counts, the handoff parity guard,
kill/resume inside the fused scan (one device, and the fused group alone
on ``[cpu] * 8``) and inside a solo stage, the regrouped resume, the
overlay's membership, resumes that re-run changed stages and their
consumers, the built-in stages, the strict artifact parsers, the ``dag``
CLI, and ``resource/workflow/run.sh`` through both command lines.  Every
output is integer-table or host float64 text, so every comparison is
byte equality.

The JAX side runs on its one-device mesh; the port's stages are built on
the CPU by ``job_resolver("cpu")``.  Each test leaves both packages'
fault injectors, artifact stores and flight recorders as it found them.
"""

import json
import os
import re

import pytest
import torch

from avenir_tpu.cli import _job_resolver as jax_resolver
from avenir_tpu.core import JobConfig as JaxConfig
from avenir_tpu.core import dag as jdag
from avenir_tpu.core import faultinject as jfi
from avenir_tpu.core import flight as jflight
from avenir_tpu.core import io as jio
from avenir_tpu.datagen.generators import gen_telecom_churn

from avenir_tpu_torch.cli import job_class, job_resolver, resolve
from avenir_tpu_torch.core import dag, faultinject, flight, io, obs
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.dag import (Stage, WorkflowConfigError,
                                       fusion_decision, load_workflow,
                                       overlay_consumed, run_workflow)
from avenir_tpu_torch.core.faultinject import FaultInjector, parse_plan
from avenir_tpu_torch.parallel.mesh import make_mesh
from avenir_tpu_torch.runbook import REPO, run_runbook

CPU = torch.device("cpu")
MESH1 = make_mesh([CPU])
MESH8 = make_mesh([CPU] * 8)
RESOLVER = job_resolver("cpu")
ALL = "bin,nb,mi,corr,select,retrain,validate,publish"


@pytest.fixture(autouse=True)
def _clean_globals():
    """Both packages' injectors, artifact stores and flight recorders as
    each test found them (a torn artifact marks the recorder's ring)."""
    prev_port, prev_jax = flight.get_recorder(), jflight.get_recorder()
    flight.set_recorder(flight.FlightRecorder())
    jflight.set_recorder(jflight.FlightRecorder())
    try:
        yield
    finally:
        faultinject.set_injector(None)
        jfi.set_injector(None)
        io.set_artifact_store(None)
        jio.set_artifact_store(None)
        flight.set_recorder(prev_port)
        jflight.set_recorder(prev_jax)


SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "plan", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["planA", "planB"]},
    {"name": "minUsed", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 2200, "bucketWidth": 200},
    {"name": "dataUsed", "ordinal": 3, "dataType": "int", "feature": True,
     "min": 0, "max": 1000, "bucketWidth": 100},
    {"name": "csCall", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 0, "max": 14, "bucketWidth": 2},
    {"name": "csEmail", "ordinal": 5, "dataType": "int", "feature": True,
     "min": 0, "max": 22, "bucketWidth": 4},
    {"name": "network", "ordinal": 6, "dataType": "int", "feature": True,
     "min": 0, "max": 12, "bucketWidth": 2},
    {"name": "churned", "ordinal": 7, "dataType": "categorical",
     "cardinality": ["N", "Y"]}]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dag_data")
    schema_path = tmp / "schema.json"
    schema_path.write_text(json.dumps(SCHEMA))
    rows = gen_telecom_churn(2500, seed=29)
    (tmp / "train").mkdir()
    (tmp / "test").mkdir()
    (tmp / "train" / "part-00000").write_text(
        "\n".join(",".join(r) for r in rows[:2000]) + "\n")
    (tmp / "test" / "part-00000").write_text(
        "\n".join(",".join(r) for r in rows[2000:]) + "\n")
    return {"schema": str(schema_path), "train": str(tmp / "train"),
            "test": str(tmp / "test")}


def _manifest(data, stages=ALL, **extra):
    props = {
        "workflow.stages": stages,
        "workflow.stage.bin.class": "org.chombo.mr.Projection",
        "workflow.stage.bin.projection.operation": "project",
        "workflow.stage.bin.projection.field": "0,1,2,3,4,5,6,7",
        "workflow.stage.nb.class": "BayesianDistribution",
        "workflow.stage.nb.input": "bin",
        "workflow.stage.nb.feature.schema.file.path": data["schema"],
        "workflow.stage.mi.class": "MutualInformation",
        "workflow.stage.mi.input": "bin",
        "workflow.stage.mi.feature.schema.file.path": data["schema"],
        "workflow.stage.corr.class": "CramerCorrelation",
        "workflow.stage.corr.input": "bin",
        "workflow.stage.corr.feature.schema.file.path": data["schema"],
        "workflow.stage.corr.source.attributes": "1",
        "workflow.stage.corr.dest.attributes": "7",
        "workflow.stage.select.class": "FeatureSelect",
        "workflow.stage.select.input": "mi",
        "workflow.stage.select.select.schema.file.path": data["schema"],
        "workflow.stage.select.select.top.features": "4",
        "workflow.stage.retrain.class": "BayesianDistribution",
        "workflow.stage.retrain.input": "bin",
        "workflow.stage.retrain.feature.schema.file.path": "@select",
        "workflow.stage.validate.class": "BayesianPredictor",
        "workflow.stage.validate.input": "path:" + data["test"],
        "workflow.stage.validate.feature.schema.file.path": "@select",
        "workflow.stage.validate.bayesian.model.file.path": "@retrain",
        "workflow.stage.publish.class": "RegistryPublish",
        "workflow.stage.publish.input": "retrain",
        "workflow.stage.publish.publish.model.name": "churn",
        "workflow.stage.publish.feature.schema.file.path": "@select",
        "pipeline.chunk.rows": "256",
        "pipeline.prefetch.depth": "2",
    }
    keep = set(stages.split(","))
    props = {k: v for k, v in props.items()
             if not k.startswith("workflow.stage.")
             or k.split(".")[2] in keep}
    props.update(extra)
    return props


def _read(base, sid) -> bytes:
    p = os.path.join(str(base), sid)
    if os.path.isfile(p):
        return open(p, "rb").read()
    return open(os.path.join(p, "part-r-00000"), "rb").read()


def _outputs(base, stages) -> dict:
    return {sid: _read(base, sid) for sid in stages.split(",")}


def _port(props, data, out, mesh=None, log=None):
    return run_workflow(JobConfig(dict(props)), data["train"], str(out),
                        RESOLVER, mesh=mesh, log=log)


def _jax(props, data, out, mesh, log=None):
    return jdag.run_workflow(JaxConfig(dict(props)), data["train"],
                             str(out), jax_resolver, mesh=mesh, log=log)


def _handoffs(msgs) -> int:
    (done,) = [m for m in msgs if "workflow complete" in m]
    return int(re.search(r"(\d+) in-memory artifact reads", done).group(1))


PIPE = {"pipeline.chunk.rows": "256", "pipeline.prefetch.depth": "2"}


def _port_standalone_chain(data, base):
    """The canonical pipeline one job at a time through the port, every
    intermediate round-tripped through a text file."""
    def run(cls, props, inp, out):
        job = job_class(cls)(JobConfig(dict(props, **PIPE), resolve(cls)[2]),
                             device="cpu")
        job.run(inp, out)

    j = os.path.join
    run("org.chombo.mr.Projection",
        {"projection.operation": "project",
         "projection.field": "0,1,2,3,4,5,6,7"},
        data["train"], j(base, "bin"))
    run("BayesianDistribution",
        {"feature.schema.file.path": data["schema"]},
        j(base, "bin"), j(base, "nb"))
    run("MutualInformation",
        {"feature.schema.file.path": data["schema"]},
        j(base, "bin"), j(base, "mi"))
    run("CramerCorrelation",
        {"feature.schema.file.path": data["schema"],
         "source.attributes": "1", "dest.attributes": "7"},
        j(base, "bin"), j(base, "corr"))
    dag.FeatureSelect(JobConfig({
        "select.schema.file.path": data["schema"],
        "select.top.features": "4"})).run(j(base, "mi"), j(base, "select"))
    run("BayesianDistribution",
        {"feature.schema.file.path": j(base, "select")},
        j(base, "bin"), j(base, "retrain"))
    run("BayesianPredictor",
        {"feature.schema.file.path": j(base, "select"),
         "bayesian.model.file.path": j(base, "retrain")},
        data["test"], j(base, "validate"))


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory, mesh1):
    """The reference's DAG over the whole canonical pipeline, with its
    log, run once for the module."""
    out = tmp_path_factory.mktemp("torch_dag_ref") / "wf"
    msgs = []
    _jax(_manifest(data, **{"workflow.fuse": "always"}), data, out, mesh1,
         log=msgs.append)
    return out, msgs


# ---------------------------------------------------------------------------
# manifest validation
# ---------------------------------------------------------------------------

BAD_MANIFESTS = [
    ({"workflow.stages": ""}, "workflow.stages is empty"),
    ({"workflow.stages": "a,a", "workflow.stage.a.class": "X"},
     "duplicate stage ids"),
    ({"workflow.stages": "a", "workflow.stage.a.class": "X",
      "workflow.stage.typo.select.top.features": "3"},
     "workflow.stage.typo.select.top.features"),
    ({"workflow.stages": "a"}, "workflow.stage.a.class"),
    ({"workflow.stages": "a", "workflow.stage.a.class": "X",
      "workflow.stage.a.input": "ghost"},
     "workflow.stage.a.input='ghost'"),
    ({"workflow.stages": "a,b",
      "workflow.stage.a.class": "X", "workflow.stage.a.input": "b",
      "workflow.stage.b.class": "X", "workflow.stage.b.input": "a"},
     "dependency cycle"),
    ({"workflow.stages": "a", "workflow.stage.a.class": "X",
      "workflow.stage.a.some.model.path": "@ghost"},
     "undeclared stage 'ghost'"),
    ({"workflow.stages": "a", "workflow.stage.a.class": "X",
      "workflow.stage.a.some.model.path": "@a"},
     "its own output"),
    ({"workflow.stages": "a,b",
      "workflow.stage.a.class": "X", "workflow.stage.a.output.path": "/t/o",
      "workflow.stage.b.class": "X", "workflow.stage.b.output.path": "/t/o"},
     "duplicates stage 'a'"),
    ({"workflow.stages": "a;b", "workflow.stage.a;b.class": "X"},
     "bad stage id"),
    ({"workflow.stages": "a,b",
      "workflow.stage.a.class": "X", "workflow.stage.a.sink.file": "false",
      "workflow.stage.b.class": "Y", "workflow.stage.b.input": "a"},
     "workflow.stage.a.sink.file=false"),
]


@pytest.mark.parametrize("overlay,fragment", BAD_MANIFESTS)
def test_manifest_validation_names_the_offending_key(tmp_path, overlay,
                                                     fragment):
    msgs = []
    for load, cfg in ((load_workflow, JobConfig),
                      (jdag.load_workflow, JaxConfig)):
        with pytest.raises((ValueError, KeyError)) as ei:
            load(cfg(dict(overlay)), str(tmp_path / "in"),
                 str(tmp_path / "out"))
        assert fragment in str(ei.value), str(ei.value)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_manifest_requires_output_derivation(tmp_path):
    cfg = JobConfig({"workflow.stages": "a", "workflow.stage.a.class": "X"})
    with pytest.raises(WorkflowConfigError, match="output.path"):
        load_workflow(cfg, str(tmp_path / "in"), None)


def test_artifact_refs_resolve_to_output_paths(tmp_path):
    props = {"workflow.stages": "a,b",
             "workflow.stage.a.class": "X",
             "workflow.stage.b.class": "Y",
             "workflow.stage.b.input": "a",
             "workflow.stage.b.bayesian.model.file.path": "@a"}
    stages = load_workflow(JobConfig(props), str(tmp_path / "in"),
                           str(tmp_path / "o"))
    ref = jdag.load_workflow(JaxConfig(props), str(tmp_path / "in"),
                             str(tmp_path / "o"))
    by_id = {s.sid: s for s in stages}
    assert by_id["b"].deps == ["a"]
    assert (by_id["b"].props["bayesian.model.file.path"]
            == by_id["a"].out_path)
    assert ([s.params_obj() for s in stages]
            == [s.params_obj() for s in ref])


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def _cost_stages(mod, n=3, fold_sec=None):
    return [mod.Stage(f"s{i}", "BayesianDistribution", {}, "$input",
                      f"/t/s{i}", True, fold_sec, []) for i in range(n)]


COST_CASES = {
    # a 50 MB scan with cheap folds: one shared scan amortizes N reads
    "scan_dominates": (3, None, 50_000_000, {}),
    # a tiny scan with heavy folds: the stages run separately
    "folds_dominate": (3, 2.0, 10_000, {}),
    "always": (2, None, 10, {"workflow.fuse": "always"}),
    "never": (2, None, 1 << 30, {"workflow.fuse": "never"}),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_model_decides_as_the_reference(case):
    n, fold_sec, scan_bytes, props = COST_CASES[case]
    fuse, d = fusion_decision(_cost_stages(dag, n, fold_sec), scan_bytes,
                              JobConfig(dict(props)))
    jfuse, jd = jdag.fusion_decision(_cost_stages(jdag, n, fold_sec),
                                     scan_bytes, JaxConfig(dict(props)))
    assert (fuse, d) == (jfuse, jd)
    assert fuse == {"scan_dominates": True, "folds_dominate": False,
                    "always": True, "never": False}[case]
    if case == "scan_dominates":
        assert d["fused_sec"] < d["separate_sec"]
        assert set(d["fold_source"].values()) == {"default"}
    if case == "folds_dominate":
        assert set(d["fold_source"].values()) == {"configured"}


def test_cost_model_refuses_an_unknown_mode():
    with pytest.raises(WorkflowConfigError, match="workflow.fuse"):
        fusion_decision(_cost_stages(dag, 2), 10,
                        JobConfig({"workflow.fuse": "maybe"}))


def test_cost_model_uses_measured_span_timings():
    """With ``multiscan.fold`` spans recorded for a stage id, the model
    takes the measured fold time over the default."""
    tr = obs.configure(enabled=True)
    tr.clear()
    try:
        with tr.span("multiscan.fold", job="s0"):
            pass
        _, d = fusion_decision(_cost_stages(dag, 2), 1_000_000,
                               JobConfig({}))
        assert d["fold_source"]["s0"] == "measured"
        assert d["fold_source"]["s1"] == "default"
    finally:
        obs.configure(enabled=False)
        tr.clear()


def test_cost_decisions_drive_the_scheduler(data, tmp_path, mesh1):
    """The same three ready stages fuse under a fusion-winning cost
    config and run separately under a losing one, with the reference's
    log line and bytes either way."""
    outs = {}
    for tag, extra in (
            ("fuse", {"workflow.cost.scan.mb.per.sec": "0.01"}),
            ("solo", {"workflow.stage.nb.cost.fold.sec": "9",
                      "workflow.stage.mi.cost.fold.sec": "9",
                      "workflow.stage.corr.cost.fold.sec": "9",
                      "workflow.cost.scan.mb.per.sec": "100000"})):
        props = _manifest(data, stages="bin,nb,mi,corr", **extra)
        msgs, jmsgs = [], []
        _port(props, data, tmp_path / tag, log=msgs.append)
        _jax(props, data, tmp_path / ("jax_" + tag), mesh1, log=jmsgs.append)
        decision = [m for m in msgs if "cost model" in m]
        assert decision == [m for m in jmsgs if "cost model" in m]
        assert len(decision) == 1, msgs
        assert (("FUSE into one shared scan" if tag == "fuse"
                 else "run separately") in decision[0])
        outs[tag] = _outputs(tmp_path / tag, "nb,mi,corr")
        assert outs[tag] == _outputs(tmp_path / ("jax_" + tag), "nb,mi,corr")
    assert outs["fuse"] == outs["solo"]


# ---------------------------------------------------------------------------
# end-to-end byte parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [None, MESH1, MESH8],
                         ids=["no_mesh", "mesh1", "mesh8"])
def test_canonical_pipeline_byte_parity(data, tmp_path, reference, mesh):
    """Every stage output of the full DAG equals the reference DAG's and
    the port's standalone chain with file handoff; ``publish`` equals
    ``retrain``; the handoff count equals the reference's.  On ``[cpu] *
    8`` the fused group and every solo stage (``retrain``, ``validate``,
    ``publish``) run on the eight positions."""
    ref_out, ref_msgs = reference
    alone = str(tmp_path / "alone")
    _port_standalone_chain(data, alone)
    wf = str(tmp_path / "wf")
    msgs = []
    _port(_manifest(data, **{"workflow.fuse": "always"}), data, wf, mesh,
          log=msgs.append)
    assert any("FUSE into one shared scan" in m for m in msgs), msgs
    for sid in ("bin", "nb", "mi", "corr", "select", "retrain",
                "validate"):
        assert _read(wf, sid) == _read(ref_out, sid), sid
        assert _read(wf, sid) == _read(alone, sid), sid
    assert _read(wf, "publish") == _read(alone, "retrain")
    assert _read(wf, "publish") == _read(ref_out, "publish")
    assert _handoffs(msgs) == _handoffs(ref_msgs)
    from avenir_tpu_torch.models.correlation import CategoricalCorrelation
    triples = CategoricalCorrelation.parse_output(
        _read(wf, "corr").decode().splitlines())
    assert triples and all(0.0 <= s <= 1.0 for _, _, s in triples)


def test_solo_nb_stage_refuses_a_mesh_of_eight(data, tmp_path, mesh8,
                                               monkeypatch):
    """A solo NB stage on ``[cpu] * 8`` (the name is kept from when the
    port refused it): its streamed fold shards every 256-row chunk over
    the eight positions and writes the reference's bytes on ``mesh8``."""
    from avenir_tpu_torch.ops import counting

    folds = []
    resident = counting.sharded_reduce_resident

    def spy(*a, **kw):
        folds.append(kw["mesh"].size)
        return resident(*a, **kw)
    monkeypatch.setattr(counting, "sharded_reduce_resident", spy)
    props = _manifest(data, stages="bin,nb")
    _port(props, data, tmp_path / "wf", MESH8)
    _jax(props, data, tmp_path / "ref", mesh8)
    assert _outputs(tmp_path / "wf", "bin,nb") == _outputs(tmp_path / "ref",
                                                           "bin,nb")
    assert folds == [8] * 8                 # 2,000 rows in 256-row chunks


# ---------------------------------------------------------------------------
# in-memory artifact handoff
# ---------------------------------------------------------------------------

def test_handoff_consumes_artifacts_from_memory(data, tmp_path, reference):
    msgs = []
    _port(_manifest(data), data, tmp_path / "wf", log=msgs.append)
    _, ref_msgs = reference
    assert _handoffs(msgs) == _handoffs(ref_msgs) >= 5


def test_optional_sink_skips_the_file_write(data, tmp_path, mesh1):
    """``sink.file=false`` on MI: no file lands, ``select`` still reads
    the artifact, outputs and handoff counts equal the reference's."""
    base = tmp_path / "sinks"
    _port(_manifest(data, stages="bin,nb,mi,select"), data, base)
    counts = {}
    for tag, run in (("port", lambda p, o, log: _port(p, data, o, log=log)),
                     ("jax", lambda p, o, log: _jax(p, data, o, mesh1,
                                                    log=log))):
        props = _manifest(data, stages="bin,nb,mi,select",
                          **{"workflow.stage.mi.sink.file": "false"})
        msgs = []
        run(props, tmp_path / tag, msgs.append)
        counts[tag] = _handoffs(msgs)
        assert not os.path.exists(tmp_path / tag / "mi")
    assert counts["port"] == counts["jax"]
    for sid in ("select", "nb"):
        assert _read(tmp_path / "port", sid) == _read(base, sid)
        assert _read(tmp_path / "port", sid) == _read(tmp_path / "jax", sid)


def test_handoff_parity_guard_catches_divergence(tmp_path):
    """A tampered artifact file is caught by manifest validation, and
    with the manifest gone by the overlay's first-read parity check."""
    store = io.ArtifactStore(verify=True)
    out = str(tmp_path / "art")
    store.register(out)
    prev = io.set_artifact_store(store)
    try:
        io.write_output(out, ["a,1", "b,2"])
        with open(os.path.join(out, "part-r-00000"), "a") as fh:
            fh.write("tampered,3\n")
        with pytest.raises(io.TornArtifactError, match="part-r-00000"):
            list(io.read_lines(out))
        os.unlink(os.path.join(out, io.MANIFEST_NAME))
        with pytest.raises(AssertionError, match="handoff parity"):
            list(io.read_lines(out))
    finally:
        io.set_artifact_store(prev)


def test_write_output_as_bare_file_and_shard(tmp_path):
    """``as_dir=False`` writes the bare file (no manifest, no marker);
    ``shard`` names the part, as the reference's writer does."""
    bare = str(tmp_path / "doc.json")
    assert io.write_output(bare, ["{", "}"], as_dir=False) == bare
    assert open(bare).read() == "{\n}\n"
    jbare = str(tmp_path / "jdoc.json")
    jio.write_output(jbare, ["{", "}"], as_dir=False)
    assert open(jbare, "rb").read() == open(bare, "rb").read()
    p = io.write_output(str(tmp_path / "d"), ["x"], shard=3)
    assert os.path.basename(p) == "part-r-00003"
    assert list(io.read_lines(str(tmp_path / "d"))) == ["x"]
    with pytest.raises(ValueError, match="shard"):
        io.write_output(str(tmp_path / "e"), ["x"], shard=1, as_dir=False)


# ---------------------------------------------------------------------------
# stage checkpoint/resume under injected faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,stages,sidecar", [
    (MESH1, "bin,nb,mi,select,retrain", "_dag_scan_mi+nb.ckpt"),
    (MESH8, "bin,nb,mi,corr", "_dag_scan_corr+mi+nb.ckpt"),
    (MESH8, "bin,nb,mi,select,retrain", "_dag_scan_mi+nb.ckpt"),
], ids=["one_device", "fused_group_cpu8", "fused_then_solo_cpu8"])
def test_kill_inside_fused_scan_resume_skips_and_restarts_midscan(
        data, tmp_path, mesh1, mesh, stages, sidecar):
    """An injected worker death inside the fused group kills the
    workflow; ``checkpoint.resume`` skips ``bin``, restarts the shared
    scan mid-file from its sidecar, and writes the uninterrupted
    reference run's bytes, leaving no sidecar."""
    extra = {"checkpoint.interval.chunks": "2", "workflow.fuse": "always"}
    ref = tmp_path / "ref"
    _jax(_manifest(data, stages=stages, **extra), data, ref, mesh1)
    want = _outputs(ref, stages)

    out = tmp_path / "out"
    faultinject.set_injector(FaultInjector(parse_plan("worker_death@5")))
    with pytest.raises(RuntimeError, match="died without signaling"):
        _port(_manifest(data, stages=stages, **extra), data, out, mesh)
    faultinject.set_injector(None)
    assert os.path.exists(out / "_workflow.ckpt")
    assert os.path.exists(out / sidecar)
    bin_mtime = os.path.getmtime(out / "bin" / "part-r-00000")

    props = _manifest(data, stages=stages, **extra)
    props["checkpoint.resume"] = "true"
    msgs = []
    _port(props, data, out, mesh, log=msgs.append)
    assert any("skipping completed stage 'bin'" in m for m in msgs), msgs
    assert any("resuming from" in m and "byte offset" in m
               for m in msgs), msgs
    assert os.path.getmtime(out / "bin" / "part-r-00000") == bin_mtime
    assert _outputs(out, stages) == want
    assert not os.path.exists(out / "_workflow.ckpt")
    assert not os.path.exists(out / sidecar)


def test_kill_inside_solo_stage_resume_skips_completed(data, tmp_path,
                                                       mesh1):
    """An injected H2D fault kills the solo NB stage; the resume skips
    ``bin``, restarts NB from its own sidecar and writes the reference's
    uninterrupted bytes."""
    stages = "bin,nb,select2"
    base = {"workflow.stage.select2.class": "org.chombo.mr.Projection",
            "workflow.stage.select2.input": "nb",
            "workflow.stage.select2.projection.operation": "project",
            "workflow.stage.select2.projection.field": "0",
            "checkpoint.interval.chunks": "2",
            "workflow.fuse": "never"}
    ref = tmp_path / "ref"
    _jax(_manifest(data, stages=stages, **base), data, ref, mesh1)
    want = _outputs(ref, stages)

    out = tmp_path / "out"
    faultinject.set_injector(FaultInjector(parse_plan("h2d@5")))
    with pytest.raises(faultinject.InjectedFault):
        _port(_manifest(data, stages=stages, **base), data, out, MESH1)
    faultinject.set_injector(None)
    assert os.path.exists(str(out / "nb") + ".ckpt"), \
        "the killed stage must leave its mid-scan sidecar"

    props = _manifest(data, stages=stages, **base)
    props["checkpoint.resume"] = "true"
    msgs = []
    _port(props, data, out, MESH1, log=msgs.append)
    assert any("skipping completed stage 'bin'" in m for m in msgs), msgs
    assert _outputs(out, stages) == want
    assert not os.path.exists(str(out / "nb") + ".ckpt")


def test_regrouped_resume_sweeps_stale_scan_sidecars(data, tmp_path):
    """A resume that groups differently never loads the old fused-group
    sidecar, and the completed workflow still sweeps it."""
    stages = "bin,nb,mi"
    extra = {"checkpoint.interval.chunks": "2", "workflow.fuse": "always"}
    out = tmp_path / "out"
    faultinject.set_injector(FaultInjector(parse_plan("worker_death@5")))
    with pytest.raises(RuntimeError):
        _port(_manifest(data, stages=stages, **extra), data, out, MESH1)
    faultinject.set_injector(None)
    stale = out / "_dag_scan_mi+nb.ckpt"
    assert os.path.exists(stale)

    props = _manifest(data, stages=stages,
                      **dict(extra, **{"workflow.fuse": "never"}))
    props["checkpoint.resume"] = "true"
    _port(props, data, out, MESH1)
    assert not os.path.exists(stale), "stale group sidecar not swept"
    assert not os.path.exists(out / "_workflow.ckpt")


def test_dataset_sized_outputs_stay_out_of_the_overlay(data, tmp_path):
    """Only artifacts read through the overlay are registered; the bin
    stage's dataset-sized output is not."""
    stages = load_workflow(JobConfig(_manifest(data)), data["train"],
                           str(tmp_path / "o"))
    assert overlay_consumed(stages) == {"mi", "select", "retrain"}
    jstages = jdag.load_workflow(JaxConfig(_manifest(data)), data["train"],
                                 str(tmp_path / "o"))
    assert jdag.overlay_consumed(jstages) == overlay_consumed(stages)

    captured = {}
    orig_register = io.ArtifactStore.register

    def spy(self, out_path, sink_file=True):
        captured.setdefault(id(self), set()).add(os.path.basename(out_path))
        return orig_register(self, out_path, sink_file=sink_file)

    io.ArtifactStore.register = spy
    try:
        _port(_manifest(data), data, tmp_path / "wf")
    finally:
        io.ArtifactStore.register = orig_register
    (registered,) = captured.values()
    assert registered == {"mi", "select", "retrain"}


def test_resume_reruns_stage_whose_config_changed(data, tmp_path):
    """A recorded stage whose params changed re-runs on resume; the
    stages with unchanged params still skip."""
    stages = "bin,nb,mi,select,retrain"
    out = tmp_path / "out"
    (tmp_path / "blocker").write_text("not a directory\n")
    props = _manifest(data, stages=stages, **{
        "workflow.fuse": "never",
        "workflow.stage.retrain.output.path":
            str(tmp_path / "blocker" / "retrain")})
    with pytest.raises(OSError):
        _port(props, data, out)
    assert os.path.exists(out / "_workflow.ckpt")

    props = _manifest(data, stages=stages, **{
        "workflow.fuse": "never",
        "workflow.stage.select.select.top.features": "2"})
    props["checkpoint.resume"] = "true"
    msgs = []
    _port(props, data, out, log=msgs.append)
    skipped = {m.split("'")[1] for m in msgs if "skipping" in m}
    assert {"bin", "nb", "mi"} <= skipped, msgs
    assert "select" not in skipped, msgs
    sel = json.loads(open(out / "select").read())
    assert len([f["name"] for f in sel["fields"] if f.get("feature")]) == 2


def test_resume_invalidates_consumers_of_rewritten_artifacts(data,
                                                             tmp_path,
                                                             mesh1):
    """``select`` re-runs with a new top-K on resume and rewrites its
    artifact at the same path: ``retrain``, recorded against the old
    schema, must re-run too, and the outputs equal a fresh reference run
    with the new selection."""
    stages = "bin,nb,mi,select,retrain,final"
    base = {"workflow.fuse": "never",
            "workflow.stage.final.class": "org.chombo.mr.Projection",
            "workflow.stage.final.input": "retrain",
            "workflow.stage.final.projection.operation": "project",
            "workflow.stage.final.projection.field": "0"}
    out = tmp_path / "out"
    (tmp_path / "blocker").write_text("not a directory\n")
    props = _manifest(data, stages=stages, **dict(
        base, **{"workflow.stage.final.output.path":
                 str(tmp_path / "blocker" / "final")}))
    with pytest.raises(OSError):
        _port(props, data, out)
    assert os.path.exists(out / "_workflow.ckpt")

    props = _manifest(data, stages=stages, **base)
    props["workflow.stage.select.select.top.features"] = "2"
    props["checkpoint.resume"] = "true"
    msgs = []
    _port(props, data, out, log=msgs.append)
    skipped = {m.split("'")[1] for m in msgs if "skipping" in m}
    assert {"bin", "nb", "mi"} <= skipped, msgs
    assert "select" not in skipped, msgs
    assert "retrain" not in skipped, \
        "retrain consumed the rewritten @select artifact — stale skip"

    fresh = tmp_path / "fresh"
    props = _manifest(data, stages=stages, **base)
    props["workflow.stage.select.select.top.features"] = "2"
    _jax(props, data, fresh, mesh1)
    for sid in ("select", "retrain", "final"):
        assert _read(out, sid) == _read(fresh, sid), sid


# ---------------------------------------------------------------------------
# built-in stages and artifact parsers
# ---------------------------------------------------------------------------

def test_feature_select_rewrites_schema(data, tmp_path, mesh1):
    from avenir_tpu.cli import _lazy, resolve as jresolve
    from avenir_tpu_torch.core.schema import FeatureSchema

    job_class("MutualInformation")(JobConfig(dict(
        {"feature.schema.file.path": data["schema"]}, **PIPE)),
        device="cpu").run(data["train"], str(tmp_path / "mi"))
    modname, clsname, prefix = jresolve("MutualInformation")
    _lazy(modname, clsname)(JaxConfig(dict(
        {"feature.schema.file.path": data["schema"]}, **PIPE), prefix)).run(
            data["train"], str(tmp_path / "jmi"), mesh=mesh1)
    assert _read(tmp_path, "mi") == _read(tmp_path, "jmi")

    cfg = {"select.schema.file.path": data["schema"],
           "select.top.features": "3"}
    counters = dag.FeatureSelect(JobConfig(cfg)).run(
        str(tmp_path / "mi"), str(tmp_path / "sel"))
    jdag.FeatureSelect(JaxConfig(cfg)).run(str(tmp_path / "jmi"),
                                           str(tmp_path / "jsel"))
    assert _read(tmp_path, "sel") == _read(tmp_path, "jsel")
    assert counters.get("Select", "Features kept") == 3
    assert counters.get("Select", "Features dropped") == 3
    doc = json.loads(open(tmp_path / "sel").read())
    by_name = {f["name"]: f for f in doc["fields"]}
    assert by_name["churned"]["classAttr"] is True
    fs = FeatureSchema.from_file(str(tmp_path / "sel"))
    assert fs.class_attr_field().name == "churned"
    assert len(fs.feature_fields()) == 3

    with pytest.raises(WorkflowConfigError, match="ranks only"):
        dag.FeatureSelect(JobConfig(dict(cfg, **{
            "select.top.features": "99"}))).run(str(tmp_path / "mi"),
                                                str(tmp_path / "sel99"))


def test_schema_from_file_reads_through_the_overlay(tmp_path):
    """With the schema's path registered sink-less, ``from_file`` finds it
    in memory: no file exists."""
    from avenir_tpu_torch.core.schema import FeatureSchema

    store = io.ArtifactStore()
    path = str(tmp_path / "schema.json")
    store.register(path, sink_file=False)
    prev = io.set_artifact_store(store)
    try:
        io.write_output(path, json.dumps(SCHEMA, indent=1).split("\n"),
                        as_dir=False)
        assert not os.path.exists(path)
        fs = FeatureSchema.from_file(path)
    finally:
        io.set_artifact_store(prev)
    assert fs.class_attr_field().name == "churned"
    assert store.memory_reads == 1


@pytest.mark.parametrize("lines", [["plan,churned"], ["a,b,xyz"],
                                   ["a,b,c,0.5"]])
def test_correlation_parse_output_strict(lines):
    from avenir_tpu.models.correlation import CategoricalCorrelation as J
    from avenir_tpu_torch.models.correlation import CategoricalCorrelation

    assert (CategoricalCorrelation.parse_output(["plan,churned,0.5"])
            == J.parse_output(["plan,churned,0.5"])
            == [("plan", "churned", 0.5)])
    for parse in (CategoricalCorrelation.parse_output, J.parse_output):
        with pytest.raises(ValueError, match="malformed correlation"):
            parse(lines)


def test_mi_parse_scores_rejects_malformed_score_lines():
    from avenir_tpu.models.mutual_info import MutualInformation as J
    from avenir_tpu_torch.models.mutual_info import MutualInformation

    good = ["mutualInformationScoreAlgorithm: mutual.info.maximization",
            "2,0.5", "1,0.25"]
    assert (MutualInformation.parse_scores(good) == J.parse_scores(good)
            == [(2, 0.5), (1, 0.25)])
    for parse in (MutualInformation.parse_scores, J.parse_scores):
        with pytest.raises(ValueError, match="malformed score line"):
            parse(good + ["garbage,0.1", "3,0.05"])
        with pytest.raises(KeyError, match="no score section"):
            parse(good, algorithm="ghost")
        with pytest.raises(ValueError, match="no mutualInformation"):
            parse(["a,1"])


def test_registry_publish_builds_a_servable_entry(data, tmp_path):
    job_class("BayesianDistribution")(JobConfig(dict(
        {"feature.schema.file.path": data["schema"]}, **PIPE)),
        device="cpu").run(data["train"], str(tmp_path / "model"))
    pub = dag.RegistryPublish(JobConfig({
        "publish.model.name": "churn",
        "feature.schema.file.path": data["schema"]}), device="cpu")
    counters = pub.run(str(tmp_path / "model"), str(tmp_path / "pub"),
                       mesh=MESH1)
    assert counters.get("Registry", "Published versions") == 1
    assert _read(tmp_path, "pub") == _read(tmp_path, "model")
    # on a mesh of eight the registry is built over the mesh and
    # publishes the same bytes
    counters = pub.run(str(tmp_path / "model"), str(tmp_path / "pub8"),
                       mesh=MESH8)
    assert counters.get("Registry", "Published versions") == 1
    assert _read(tmp_path, "pub8") == _read(tmp_path, "model")


# ---------------------------------------------------------------------------
# the `dag` CLI and the runbook
# ---------------------------------------------------------------------------

def test_dag_cli_end_to_end(data, tmp_path, capsys):
    from avenir_tpu_torch import cli

    props = _manifest(data, stages="bin,nb,mi,select")
    (tmp_path / "workflow.properties").write_text(
        "\n".join(f"{k}={v}" for k, v in props.items()) + "\n")
    rc = cli.main(["dag", f"-Dconf.path={tmp_path}/workflow.properties",
                   data["train"], str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "--- stage nb" in err and "--- stage select" in err
    assert "workflow complete" in err
    assert os.path.exists(tmp_path / "out" / "nb" / "part-r-00000")
    assert os.path.exists(tmp_path / "out" / "select")


@pytest.fixture(scope="module")
def runbook(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dag_runbook")
    src = os.path.join(REPO, "resource", "workflow")
    env = {"JAX_PLATFORMS": "cpu", "AVENIR_PLATFORM": "cpu"}
    return (tmp, run_runbook(src, str(tmp / "jax"), port=False, env=env),
            run_runbook(src, str(tmp / "port"), device="cpu", env=env))


@pytest.mark.parametrize("sid", ALL.split(","))
def test_workflow_runbook_matches_reference(runbook, sid):
    tmp, _, _ = runbook
    got = _read(tmp / "port" / "work" / "out", sid)
    assert got and got == _read(tmp / "jax" / "work" / "out", sid)


def test_workflow_runbook_fuses_and_counts_handoffs(runbook):
    tmp, jlog, plog = runbook
    line = [l for l in plog.splitlines() if "cost model" in l]
    assert line == [l for l in jlog.splitlines() if "cost model" in l]
    assert "stages [nb,mi,corr]" in line[0]
    assert "FUSE into one shared scan" in line[0]
    assert _handoffs(plog.splitlines()) == _handoffs(jlog.splitlines())
    assert "publish == retrain (byte-identical)" in plog
    assert (_read(tmp / "port" / "work" / "out", "publish")
            == _read(tmp / "port" / "work" / "out", "retrain"))
