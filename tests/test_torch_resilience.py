"""The port's NB training resilience layer held against the JAX package
on the CPU: fault plans, retries, row quarantine, checkpoint and resume,
and tracing spans.

Input: 4,000 seeded churn rows (the reference's tests/test_resilience.py
fixture) in 256-row chunks.  Contract: a killed run resumed with
``--resume`` writes the reference's uninterrupted model byte for byte;
under an error budget the model and the ``.quarantine`` sidecar are the
reference's bytes; a sidecar that does not match the run is refused as
the reference refuses it; the spans carry the reference's names.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from avenir_tpu.core import faultinject as jfi
from avenir_tpu.core import obs as jobs
from avenir_tpu.core import resilience as jres
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.models import bayesian as jb

from avenir_tpu_torch import datagen, native
from avenir_tpu_torch.cli import main as cli_main
from avenir_tpu_torch.core import faultinject, obs, pipeline, resilience
from avenir_tpu_torch.core.checkpoint import (CarryNotPortable,
                                              CheckpointCorrupt,
                                              CheckpointMismatch,
                                              StreamCheckpointer,
                                              assert_portable_carry)
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.faultinject import (FaultInjector, InjectedFault,
                                               InjectedReadError,
                                               SimulatedWorkerDeath,
                                               parse_plan)
from avenir_tpu_torch.core.io import _durability_counters
from avenir_tpu_torch.core.resilience import (ErrorBudgetExceeded,
                                              RetryPolicy, RowQuarantine,
                                              with_retries)
from avenir_tpu_torch.models import bayesian as tb

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
N_ROWS, CHUNK_ROWS = 4000, 256
N_CHUNKS = -(-N_ROWS // CHUNK_ROWS)


@pytest.fixture(autouse=True)
def _clear_global_state():
    """Every test leaves both packages' injectors unset and tracers off."""
    yield
    faultinject.set_injector(None)
    jfi.set_injector(None)
    obs.configure(enabled=False)
    obs.get_tracer().clear()
    jobs.configure(enabled=False)
    jobs.get_tracer().clear()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_resilience")
    rows = datagen.gen_telecom_churn(N_ROWS, seed=5)
    lines = [",".join(r) for r in rows]
    (tmp / "in.csv").write_text("\n".join(lines) + "\n")
    (tmp / "schema.json").write_text(json.dumps(SCHEMA))
    dirty = []
    for i, l in enumerate(lines):
        dirty.append(l)
        if i % 500 == 250:
            dirty.append("garbage,row")                      # short row
            dirty.append(l.rsplit(",", 2)[0] + ",noNum,Y")   # bad numeric
    (tmp / "dirty.csv").write_text("\n".join(dirty) + "\n")
    d = {"dir": tmp, "in": str(tmp / "in.csv"),
         "dirty": str(tmp / "dirty.csv"),
         "schema": str(tmp / "schema.json"),
         "n_dirty_rows": 2 * ((len(lines) + 249) // 500)}
    jb.BayesianDistribution(JaxConfig(_props(d))).run(
        d["in"], str(tmp / "ref_jax"))
    d["ref"] = _model(tmp / "ref_jax")
    return d


def _props(data, **extra):
    props = {"feature.schema.file.path": data["schema"],
             "pipeline.chunk.rows": str(CHUNK_ROWS),
             "pipeline.prefetch.depth": "2"}
    props.update({k: str(v) for k, v in extra.items()})
    return props


def _port(data, **extra):
    return tb.BayesianDistribution(JobConfig(_props(data, **extra)),
                                   device="cpu")


def _model(out_dir):
    with open(os.path.join(out_dir, "part-r-00000"), "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# fault plans and retries: the reference's grammar, firings and ladder
# ---------------------------------------------------------------------------

def test_fault_plan_grammar_matches_reference():
    text = "read@0-1, corrupt@3:truncate; slow@5x2:7,worker_death@*,h2d@4"
    got = [repr(e) for e in parse_plan(text)]
    assert got == [repr(e) for e in jfi.parse_plan(text)]
    # the serving points came with the port's server
    serving = ("scorer@0-7, scorer_slow[f32]@*:40, batcher_death@0, "
               "scorer_poison@*:BAD, promote_fail[m]@0")
    assert [repr(e) for e in parse_plan(serving)] \
        == [repr(e) for e in jfi.parse_plan(serving)]
    for bad in ("nosuchpoint@1", "read", "read@1x0", "scorer[@0"):
        with pytest.raises(ValueError):
            parse_plan(bad)
        with pytest.raises(ValueError):
            jfi.parse_plan(bad)


def test_fault_firing_is_deterministic_and_bounded():
    fi = FaultInjector(parse_plan("read@1-2"))
    fi.fire("read")
    for _ in range(2):
        with pytest.raises(InjectedReadError):
            fi.fire("read")
    fi.fire("read")
    fi2 = FaultInjector(parse_plan("h2d@4x2"))
    fi2.fire("h2d", 3)
    for _ in range(2):
        with pytest.raises(InjectedFault):
            fi2.fire("h2d", 4)
    fi2.fire("h2d", 4)
    with pytest.raises(SimulatedWorkerDeath):
        FaultInjector(parse_plan("worker_death@2")).fire("worker_death", 2)


@pytest.mark.parametrize("plan,seed", [("corrupt@2", 7), ("corrupt@2", 2026),
                                       ("corrupt@0:truncate", 1)])
def test_corrupt_mangle_matches_reference_bytes(plan, seed):
    data = b"aaa,1,2\nbbb,3,4\n" * 64
    idx = int(plan.split("@")[1].split(":")[0])
    got = FaultInjector(parse_plan(plan), seed=seed).mangle("corrupt", idx,
                                                            data)
    want = jfi.FaultInjector(jfi.parse_plan(plan), seed=seed).mangle(
        "corrupt", idx, data)
    assert got == want != data


def test_retry_recovers_exhausts_and_fails_fast():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    before = resilience.retry_counters().get("Retry", "attempts")
    pol = RetryPolicy(max_attempts=3, base_ms=0.1, jitter=0.0)
    assert with_retries(flaky, policy=pol, op="test") == "ok"
    assert resilience.retry_counters().get("Retry", "attempts") == before + 2

    def always():
        raise OSError("still down")
    with pytest.raises(OSError, match="still down"):
        with_retries(always, policy=pol, op="test")
    missing = []

    def gone():
        missing.append(1)
        raise FileNotFoundError("/no/such/input")
    with pytest.raises(FileNotFoundError):
        with_retries(gone, policy=RetryPolicy(max_attempts=5, base_ms=50))
    assert len(missing) == 1
    assert not RetryPolicy().is_retryable(InjectedFault("x"))


def test_backoff_ladder_matches_reference():
    a = RetryPolicy(base_ms=10, max_ms=40, jitter=0.5, seed=3)
    b = jres.RetryPolicy(base_ms=10, max_ms=40, jitter=0.5, seed=3)
    assert ([a.backoff_s(i) for i in range(1, 7)]
            == [b.backoff_s(i) for i in range(1, 7)])


def test_transient_read_fault_is_retried_end_to_end(data, tmp_path):
    resilience.set_policy(RetryPolicy(max_attempts=3, base_ms=0.5))
    try:
        fi = faultinject.set_injector(FaultInjector(parse_plan("read@0-1")))
        _port(data).run(data["in"], str(tmp_path / "out"))
        assert _model(tmp_path / "out") == data["ref"]
        assert fi.fired_log == [("read", 0), ("read", 1)]
        faultinject.set_injector(FaultInjector(parse_plan("read@*")))
        with pytest.raises(InjectedReadError):
            _port(data).run(data["in"], str(tmp_path / "out2"))
    finally:
        resilience.set_policy(RetryPolicy())


# ---------------------------------------------------------------------------
# checkpoint and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("plan,dies_with", [
    ("h2d@9", (InjectedFault,)),
    ("worker_death@8", (RuntimeError, SimulatedWorkerDeath))])
def test_kill_resume_matches_reference_uninterrupted(data, tmp_path, depth,
                                                     plan, dies_with):
    """Kill the streamed train mid-file, resume from the sidecar, and the
    model is the reference's uninterrupted model, byte for byte."""
    cfg = {"checkpoint.interval.chunks": "3",
           "pipeline.prefetch.depth": str(depth)}
    out = str(tmp_path / "out")
    faultinject.set_injector(FaultInjector(parse_plan(plan)))
    with pytest.raises(dies_with):
        _port(data, **cfg).run(data["in"], out)
    faultinject.set_injector(None)
    ckpt = out + ".ckpt"
    assert os.path.exists(ckpt), "a killed run leaves its checkpoint"
    with open(ckpt, "rb") as fh:
        payload = pickle.load(fh)
    assert payload["chunk_index"] in (2, 5)
    assert isinstance(payload["carry"], np.ndarray)
    durability = _durability_counters().as_dict().get("Durability", {})
    native.reset_call_counts()
    _port(data, **cfg, **{"checkpoint.resume": "true"}).run(data["in"], out)
    assert _model(out) == data["ref"]
    assert not os.path.exists(ckpt), "success clears the checkpoint"
    # the run continued from the sidecar: it parsed only the chunks the
    # sidecar did not cover, and no generation was refused on the way
    assert native.ENCODE_CALLS == N_CHUNKS - (payload["chunk_index"] + 1)
    assert _durability_counters().as_dict().get("Durability", {}) \
        == durability


def test_cli_resume_flag_and_missing_sidecar(data, tmp_path):
    """``--resume`` with no sidecar runs from the start; after a kill it
    resumes (through the CLI's fault plan)."""
    base = [f"-D{k}={v}" for k, v in _props(data).items()]
    out = str(tmp_path / "out")
    assert cli_main(["BayesianDistribution", *base, data["in"], out,
                     "--resume", "--device", "cpu"]) == 0
    assert _model(out) == data["ref"]
    out2 = str(tmp_path / "out2")
    with pytest.raises(InjectedFault):
        cli_main(["BayesianDistribution", *base,
                  "-Dcheckpoint.interval.chunks=3",
                  "-Dfault.inject.plan=h2d@9", data["in"], out2,
                  "--device", "cpu"])
    with open(out2 + ".ckpt", "rb") as fh:
        covered = pickle.load(fh)["chunk_index"] + 1
    native.reset_call_counts()
    assert cli_main(["BayesianDistribution", *base,
                     "-Dcheckpoint.interval.chunks=3", data["in"], out2,
                     "--device=cpu", "--resume"]) == 0
    assert faultinject.get_injector() is None
    assert _model(out2) == data["ref"]
    assert native.ENCODE_CALLS == N_CHUNKS - covered


def _killed(data, tmp_path, **cfg):
    faultinject.set_injector(FaultInjector(parse_plan("h2d@9")))
    with pytest.raises(InjectedFault):
        _port(data, **{"checkpoint.interval.chunks": "3", **cfg}).run(
            data["in"], str(tmp_path / "out"))
    faultinject.set_injector(None)
    return str(tmp_path / "out") + ".ckpt"


def test_checkpoint_refuses_other_input_and_chunking(data, tmp_path):
    ckpt = _killed(data, tmp_path)
    other = tmp_path / "other.csv"
    other.write_text(open(data["in"]).read() + "x9999,planA,100,100,2,4,6,N\n")
    with pytest.raises(CheckpointMismatch, match="different input"):
        _port(data, **{"checkpoint.interval.chunks": "3",
                       "checkpoint.resume": "true",
                       "checkpoint.path": ckpt}).run(
            str(other), str(tmp_path / "out2"))
    with pytest.raises(CheckpointMismatch, match="params changed"):
        _port(data, **{"checkpoint.interval.chunks": "3",
                       "checkpoint.resume": "true",
                       "pipeline.chunk.rows": "512"}).run(
            data["in"], str(tmp_path / "out"))


def test_corrupt_sidecar_falls_back_or_fails(data, tmp_path):
    ckpt = _killed(data, tmp_path)
    assert os.path.exists(ckpt + ".1"), "the previous generation is kept"
    with open(ckpt, "r+b") as fh:
        fh.truncate(os.path.getsize(ckpt) // 2)
    out = str(tmp_path / "out")
    cfg = {"checkpoint.interval.chunks": "3", "checkpoint.resume": "true"}
    ck = StreamCheckpointer.from_config(
        JobConfig(_props(data, **cfg)), "nb-train", data["in"], ckpt,
        params={"chunk_bytes": 48 << 20, "chunk_rows": 256, "delim": ","})
    fallbacks = _durability_counters().get("Durability",
                                           "Generation fallbacks")
    assert ck.load()["chunk_index"] == 2      # the older generation
    assert _durability_counters().get("Durability",
                                      "Generation fallbacks") == fallbacks + 1
    with open(ckpt + ".1", "wb") as fh:
        fh.write(b"not a pickle")
    with pytest.raises(CheckpointCorrupt):
        _port(data, **cfg, **{"checkpoint.fallback": "fail"}).run(
            data["in"], out)
    cold = _durability_counters().get("Durability", "Cold starts")
    _port(data, **cfg).run(data["in"], out)     # cold: a full run
    assert _model(out) == data["ref"]
    assert _durability_counters().get("Durability", "Cold starts") \
        == cold + 1


def test_carry_must_be_host_data():
    assert_portable_carry({"c": np.zeros(3), "n": 1, "t": (None, 2.0)})
    with pytest.raises(CarryNotPortable, match="torch"):
        assert_portable_carry({"c": torch.zeros(3)})


def test_snapshot_is_a_host_copy_of_this_fold():
    cf = pipeline.ChunkFold(tb._nb_local, static_args=(2, 4),
                            device=torch.device("cpu"))
    x = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    y = torch.tensor([0, 1], dtype=torch.int32)
    cf.fold((x, y, None))
    snap = cf.snapshot()
    cf.fold((x, y, None))
    first = pipeline.ChunkFold.host_copy(snap)
    assert isinstance(first, np.ndarray)
    np.testing.assert_array_equal(first * 2, cf.result())


# ---------------------------------------------------------------------------
# row quarantine
# ---------------------------------------------------------------------------

def test_quarantine_budget_math(tmp_path):
    q = RowQuarantine(str(tmp_path / "q"), "2")
    q.record(["bad1"], "r")
    q.record(["bad2"], "r")
    with pytest.raises(ErrorBudgetExceeded, match="inspect"):
        q.record(["bad3"], "r")
    qf = RowQuarantine(str(tmp_path / "qf"), "0.5")
    qf.admit(10)
    qf.record(["a", "b", "c"], "r")
    qf.finish()
    qe = RowQuarantine(str(tmp_path / "qe"), "0.1")
    qe.admit(5)
    qe.record(["a", "b"], "r")
    with pytest.raises(ErrorBudgetExceeded):
        qe.finish()


@pytest.mark.parametrize("case", ["dirty-file", "corrupt@2"])
def test_quarantine_model_and_sidecar_match_reference(data, tmp_path, case):
    """Malformed rows (a dirty file, or a chunk mangled by ``corrupt@2``)
    go to the quarantine sidecar; the model and the sidecar are the
    reference's bytes."""
    src = data["dirty"] if case == "dirty-file" else data["in"]
    extra = {"ingest.error.budget": "100" if case == "dirty-file" else "0.2"}
    outs = {}
    for name, make in (("jax", lambda: jb.BayesianDistribution(
            JaxConfig(_props(data, **extra)))),
                       ("port", lambda: _port(data, **extra))):
        if case != "dirty-file":
            faultinject.set_injector(FaultInjector(parse_plan(case)))
            jfi.set_injector(jfi.FaultInjector(jfi.parse_plan(case)))
        out = str(tmp_path / name)
        counters = make().run(src, out)
        with open(out + ".quarantine", "rb") as fh:
            outs[name] = (_model(out), fh.read(),
                          counters.get("Ingest", "Quarantined rows"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][2] >= 1
    if case == "dirty-file":
        assert outs["port"][0] == data["ref"]
        assert outs["port"][2] == data["n_dirty_rows"]


def test_budget_exceeded_names_the_sidecar(data, tmp_path):
    out = str(tmp_path / "out")
    with pytest.raises(ErrorBudgetExceeded) as ei:
        _port(data, **{"ingest.error.budget": "3"}).run(data["dirty"], out)
    assert out + ".quarantine" in str(ei.value)


def test_one_shot_quarantine_prefilter_matches_reference(data, tmp_path):
    """The one-shot encode's pre-filter: the same good rows, the same
    sidecar bytes."""
    extra = {"ingest.error.budget": "100"}
    ds = _port(data, **extra)._encode_monolithic(
        data["dirty"], str(tmp_path / "port"), ",", tb.Counters())
    jds = jb.BayesianDistribution(JaxConfig(_props(data, **extra))) \
        ._encode_monolithic(data["dirty"], str(tmp_path / "jax"), ",",
                            jb.Counters())
    np.testing.assert_array_equal(ds.x, jds.x)
    np.testing.assert_array_equal(ds.y, jds.y)
    with open(str(tmp_path / "port") + ".quarantine", "rb") as a, \
            open(str(tmp_path / "jax") + ".quarantine", "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _span_names(tracer):
    return sorted({s.name for s in tracer.spans()})


@pytest.mark.parametrize("extra", [
    {"checkpoint.interval.chunks": "3"},
    {"ingest.parse.threads": "4", "pipeline.prefetch.depth": "0"}],
    ids=["checkpointed", "parallel-parse-serial-fold"])
def test_spans_match_reference_names(data, tmp_path, extra):
    obs.configure(enabled=True)
    jobs.configure(enabled=True)
    _port(data, **extra).run(data["in"], str(tmp_path / "port"))
    jb.BayesianDistribution(JaxConfig(_props(data, **extra))).run(
        data["in"], str(tmp_path / "jax"))
    names = _span_names(obs.get_tracer())
    assert names == _span_names(jobs.get_tracer())
    for want in ("job:BayesianDistribution", "phase:train", "phase:emit",
                 "ingest.read", "ingest.parse", "ingest.h2d", "ingest.fold"):
        assert want in names
    assert ("checkpoint.save" in names) == ("checkpoint.interval.chunks"
                                            in extra)
    # the prefetch worker's spans parent under phase:train's tree
    spans = obs.get_tracer().spans()
    ids = {s.span_id for s in spans}
    assert all(s.parent_id in ids for s in spans
               if s.name in ("ingest.h2d", "ingest.parse"))


def test_cli_trace_writes_chrome_trace(data, tmp_path):
    trace = str(tmp_path / "trace.json")
    base = [f"-D{k}={v}" for k, v in _props(data).items()]
    assert cli_main(["BayesianDistribution", *base, data["in"],
                     str(tmp_path / "out"), "--trace", trace,
                     "--device", "cpu"]) == 0
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"phase:train", "phase:emit", "ingest.parse"} <= names
    assert "ingest.prefetch.queue.depth" in {e["name"] for e in events
                                             if e.get("ph") == "C"}


# ---------------------------------------------------------------------------
# the ckpt_corrupt and torn_write fault points, through both packages
# ---------------------------------------------------------------------------

def _both_checkpointers(tmp_path, in_path, resume=False):
    from avenir_tpu.core.checkpoint import StreamCheckpointer as JaxCk
    kw = dict(interval=2, kind="t", in_path=in_path, params={"p": 1},
              resume=resume, keep=2)
    return (StreamCheckpointer(str(tmp_path / "port.ckpt"), **kw),
            JaxCk(str(tmp_path / "jax.ckpt"), **kw))


def test_ckpt_corrupt_truncates_by_save_index_as_the_reference(tmp_path):
    """``ckpt_corrupt@1`` (the reference's
    tests/test_durability.py:273-281): saves at offsets 10 and 30, the
    second truncated to half its size, and the resume falls back to the
    older generation at offset 10, in both packages."""
    src = tmp_path / "in.csv"
    src.write_text("a,b\n" * 8)
    port, ref = _both_checkpointers(tmp_path, str(src))
    for ck, fi in ((port, faultinject), (ref, jfi)):
        fi.set_injector(fi.FaultInjector(fi.parse_plan("ckpt_corrupt@1")))
        ck.save(ck.token(1, 10, {}), None)
        whole = os.path.getsize(ck.path)
        ck.save(ck.token(3, 30, {}), None)
        fi.set_injector(None)
        assert os.path.getsize(ck.path) == max(whole // 2, 1)
        assert os.path.getsize(ck.path + ".1") == whole
    port, ref = _both_checkpointers(tmp_path, str(src), resume=True)
    assert port.load()["offset"] == ref.load()["offset"] == 10


def test_torn_write_tears_the_part_as_the_reference(tmp_path):
    """``torn_write@0`` (the reference's tests/test_durability.py:167-180):
    the republish dies with ``InjectedFault`` leaving half the staged bytes
    under the final name, the reader refuses the directory, and a clean
    republish heals it, in both packages."""
    from avenir_tpu.core import io as jio
    from avenir_tpu_torch.core import io as tio

    torn = {}
    for name, fi, io_mod in (("port", faultinject, tio), ("jax", jfi, jio)):
        out = str(tmp_path / name)
        io_mod.write_output(out, [f"v1,{i}" for i in range(100)])
        fi.set_injector(fi.FaultInjector(fi.parse_plan("torn_write@0")))
        with pytest.raises(fi.InjectedFault, match="torn write"):
            io_mod.write_output(out, [f"v2,{i}" for i in range(100)])
        fi.set_injector(None)
        with pytest.raises(io_mod.TornArtifactError):
            list(io_mod.read_lines(out))
        assert not [f for f in os.listdir(out) if f.startswith(".")]
        with open(os.path.join(out, "part-r-00000"), "rb") as fh:
            torn[name] = fh.read()
        io_mod.write_output(out, [f"v2,{i}" for i in range(100)])
        assert len(list(io_mod.read_lines(out))) == 100
    assert torn["port"] == torn["jax"]
    assert torn["port"].startswith(b"v2,0\n")


def test_torn_ingest_cache_publish_is_best_effort(data, tmp_path):
    """The contract of the reference's tests/test_ingestcache.py:335 after
    the repair: a torn publish returns False without failing the run,
    leaves no ``_SUCCESS``, never serves, and the next build heals."""
    from avenir_tpu_torch.core import ingestcache
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.io import SUCCESS_NAME
    from avenir_tpu_torch.core.schema import FeatureSchema

    enc = DatasetEncoder(FeatureSchema.from_file(data["schema"]))
    cache = ingestcache.IngestCache(str(tmp_path / "cache"), data["in"],
                                    enc, ",")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 5, (50, 6)).astype(np.int32)
    vals = rng.random((50, 6))
    y = rng.integers(0, 2, 50).astype(np.int32)
    b = cache.builder(50)
    b.add(x, vals, y, 50)
    faultinject.set_injector(FaultInjector(parse_plan("torn_write@0")))
    assert b.finish() is False
    faultinject.set_injector(None)
    assert not os.path.isfile(os.path.join(cache.dir, SUCCESS_NAME))
    assert cache.load(50) is None
    b2 = cache.builder(50)
    b2.add(x, vals, y, 50)
    assert b2.finish() is True
    np.testing.assert_array_equal(np.asarray(cache.load(50).x), x)


def test_faulttolerance_runbook_through_the_port(tmp_path):
    """``resource/faulttolerance/run.sh`` (all but its server leg, which
    tests/test_torch_serve.py holds) through ``avenir_tpu_torch.cli.main``
    with ``--device cpu``: the ``h2d`` kill and the resume through two
    retried ``read`` faults, the quarantine, the generation fallback past
    a garbled newest sidecar, and the ``torn_write`` crash that readers
    refuse until a republish heals it.  Every model is the reference's
    uninterrupted model."""
    import contextlib
    import io
    import shutil

    from avenir_tpu.cli import main as jax_main
    from avenir_tpu_torch.core.io import (TornArtifactError, read_lines,
                                          set_require_success)

    book = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "resource", "faulttolerance")
    for f in ("nb.properties", "teleComChurn.json"):
        shutil.copy(os.path.join(book, f), tmp_path)
    cwd = os.getcwd()
    os.chdir(tmp_path)

    def port(*argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            return cli_main(["BayesianDistribution",
                             "-Dconf.path=nb.properties", *argv,
                             "--device", "cpu"])

    try:
        assert datagen.main(["telecom_churn", "60000", "--seed", "41",
                             "--out", "work/in/part-00000"]) == 0
        lines = open("work/in/part-00000").read().splitlines()
        out = []
        for i, l in enumerate(lines):
            out.append(l)
            if i % 10000 == 5000:
                out.append("truncated,row")
                out.append(l.rsplit(",", 2)[0] + ",notANumber,Y")
        open("work/in/part-00000", "w").write("\n".join(out) + "\n")
        with contextlib.redirect_stderr(io.StringIO()):
            assert jax_main(["BayesianDistribution",
                             "-Dconf.path=nb.properties", "work/in",
                             "work/jref"]) == 0
        ref = _model("work/jref")

        assert port("work/in", "work/ref") == 0
        assert _model("work/ref") == ref
        with pytest.raises(InjectedFault):
            port("-Dfault.inject.plan=h2d@9", "work/in", "work/model")
        assert os.path.exists("work/model.ckpt")
        assert port("-Dfault.inject.plan=read@0-1", "--resume", "work/in",
                    "work/model") == 0
        assert _model("work/model") == ref
        assert not os.path.exists("work/model.ckpt")
        def rows(path):
            return [l for l in open(path) if not l.startswith("#")]
        # the clean run's sidecar is the reference's; the resumed run's
        # holds every one of its rows (chunks re-read after the
        # checkpoint add theirs again)
        assert rows("work/ref.quarantine") == rows("work/jref.quarantine")
        assert len(rows("work/ref.quarantine")) == 12
        assert set(rows("work/model.quarantine")) == set(
            rows("work/ref.quarantine"))

        with pytest.raises(InjectedFault):
            port("-Dfault.inject.plan=h2d@9", "work/in", "work/model2")
        assert os.path.exists("work/model2.ckpt.1")
        blob = open("work/model2.ckpt", "rb").read()
        open("work/model2.ckpt", "wb").write(blob[:max(len(blob) // 3, 1)])
        assert port("--resume", "work/in", "work/model2") == 0
        assert _model("work/model2") == ref

        with pytest.raises(InjectedFault, match="torn write"):
            port("-Dfault.inject.plan=torn_write@0", "work/in", "work/ref")
        with pytest.raises(TornArtifactError):
            list(read_lines("work/ref"))
        prev = set_require_success(True)
        try:
            with pytest.raises(TornArtifactError, match="_SUCCESS"):
                list(read_lines("work/in"))
        finally:
            set_require_success(prev)
        assert port("work/in", "work/ref") == 0
        assert _model("work/ref") == ref
    finally:
        os.chdir(cwd)
