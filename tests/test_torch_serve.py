"""The port's prediction server held against the JAX package's on the CPU.

The same artifacts (the serving runbook's churn set: telecom_churn 3000,
seed 29, 2,400 rows trained and 600 scored; the kNN and Markov fixtures of
tests/test_serve.py) are built with both packages from one seed, and the
reference ``avenir_tpu.serve.PredictionServer`` and the port's run in
this process, each on port 0, with ``resource/serving/serve.properties``'s
values (variants f32,f64, two replicas, micro-batches up to 64 with a
2 ms delay, warmup at every power-of-two bucket).  Naive Bayes responses
must equal the reference server's and the port's batch predictor's byte
for byte; kNN responses are held to the reference's one-unit contract.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output as jax_write_output
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.datagen import (gen_retarget, gen_state_sequences,
                                gen_telecom_churn)
from avenir_tpu.models import tree as jtree
from avenir_tpu.serve import PredictionServer as JaxServer
from avenir_tpu.serve import engine as jengine

from avenir_tpu_torch.core import telemetry
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models.bayesian import (BayesianDistribution,
                                              BayesianPredictor)
from avenir_tpu_torch.models.markov import (MarkovModelClassifier,
                                            MarkovStateTransitionModel)
from avenir_tpu_torch.models.split import AttributePredicate, predicate_matrix
from avenir_tpu_torch.models.tree import DecisionPathList, _column
from avenir_tpu_torch.serve import PredictionServer, engine
from avenir_tpu_torch.serve.engine import SERVE_GROUP
from avenir_tpu_torch.serve.registry import ModelRegistry
from avenir_tpu_torch.serve.server import request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = os.path.join(REPO, "resource", "serving", "teleComChurn.json")
HOST = "127.0.0.1"

# rows that fail per row: an out-of-vocabulary category, a numeric past
# its declared max, a negative numeric, a field that does not parse, and
# a record too short to score
BAD_ROWS = ["X1,planZ,1210,505,8,11,3,Y", "X2,planA,9999,505,8,11,3,N",
            "X3,planB,-400,505,8,11,3,N", "X4,planA,12x0,505,8,11,3,N",
            "X5,planA"]

KNN_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "a", "ordinal": 1, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "b", "ordinal": 2, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "cls", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["N", "Y"]}]}
KNN_PROPS = {"top.match.count": "5", "kernel.function": "none",
             "validation.mode": "true"}


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    rows = [",".join(r) for r in gen_telecom_churn(3000, seed=29)]
    jax_write_output(str(tmp / "train"), rows[:2400])
    jax_write_output(str(tmp / "test"), rows[2400:])
    BayesianDistribution(JobConfig({"feature.schema.file.path": SCHEMA}),
                         device="cpu").run(str(tmp / "train"),
                                           str(tmp / "model"))
    bp = {"feature.schema.file.path": SCHEMA,
          "bayesian.model.file.path": str(tmp / "model")}
    batch = {}
    for variant, precision in (("f32", "float32"), ("f64", "float64")):
        out = str(tmp / f"pred_{variant}")
        BayesianPredictor(JobConfig(dict(bp, **{
            "bp.score.precision": precision})), device="cpu").run(
            str(tmp / "test"), out)
        with open(os.path.join(out, "part-r-00000")) as fh:
            batch[variant] = fh.read().splitlines()

    # the kNN fixture of tests/test_serve.py:137-170
    with open(tmp / "knn_schema.json", "w") as fh:
        json.dump(KNN_SCHEMA, fh)
    rng = np.random.default_rng(7)
    kr = []
    for i in range(120):
        y = i % 2
        a = float(np.clip(rng.normal(3 + 4 * y, 1.0), 0, 10))
        b = float(np.clip(rng.normal(7 - 4 * y, 1.0), 0, 10))
        kr.append(f"K{i},{a:.3f},{b:.3f},{'Y' if y else 'N'}")
    with open(tmp / "knn_train.csv", "w") as fh:
        fh.write("\n".join(kr[:90]) + "\n")
    return {"bp": bp, "test": rows[2400:], "batch": batch,
            "knn_test": kr[90:],
            "knn": dict(KNN_PROPS, **{
                "feature.schema.file.path": str(tmp / "knn_schema.json"),
                "train.data.path": str(tmp / "knn_train.csv")})}


def _props(arts, **over):
    """resource/serving/serve.properties with both models inline."""
    props = {"serve.models": "churn,neighbors",
             "serve.model.churn.kind": "naiveBayes",
             "serve.model.churn.variants": "f32,f64",
             "serve.model.neighbors.kind": "nearestNeighbor",
             "serve.pool.replicas": "2",
             "serve.batch.max.size": "64",
             "serve.batch.max.delay.ms": "2",
             "serve.queue.max.depth": "256",
             "serve.port": "0"}
    for k, v in arts["bp"].items():
        props[f"serve.model.churn.{k}"] = v
    for k, v in arts["knn"].items():
        props[f"serve.model.neighbors.{k}"] = v
    props.update(over)
    return props


@pytest.fixture(scope="module")
def servers(arts):
    port_srv = PredictionServer(JobConfig(_props(arts)), device="cpu")
    ref_srv = JaxServer(JaxConfig(_props(arts)))
    try:
        yield (port_srv, port_srv.start()), (ref_srv, ref_srv.start())
    finally:
        port_srv.stop()
        ref_srv.stop()


def _ask(port, obj):
    resp = request(HOST, port, obj)
    resp.pop("trace_id", None)       # random per request
    return resp


# ---------------------------------------------------------------------------
# Naive Bayes: byte parity with the reference server and the batch job
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["f32", "f64"])
def test_nb_responses_match_reference_and_batch(servers, arts, variant):
    (_, port), (_, ref) = servers
    test, batch = arts["test"], arts["batch"][variant]
    for lo in range(0, len(test), 64):
        obj = {"model": "churn", "rows": test[lo:lo + 64],
               "variant": variant}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj)
        assert mine["variant"] == variant
        assert mine["outputs"] == batch[lo:lo + 64]
    for i in (0, 1, 599):
        obj = {"model": "churn", "row": test[i], "variant": variant}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj) and mine["output"] == batch[i]


@pytest.mark.parametrize("variant", ["f32", "f64"])
def test_nb_per_row_errors_match_reference(servers, arts, variant):
    """Out-of-domain, unparsable and too-short rows fail on their own,
    in a batch and alone, exactly as the reference's do."""
    (_, port), (_, ref) = servers
    rows = BAD_ROWS + arts["test"][:3] + BAD_ROWS[:2]
    obj = {"model": "churn", "rows": rows, "variant": variant}
    mine = _ask(port, obj)
    assert mine == _ask(ref, obj)
    assert mine["errors"] == len(BAD_ROWS) + 2
    assert mine["outputs"][len(BAD_ROWS):len(BAD_ROWS) + 3] \
        == arts["batch"][variant][:3]
    for row in BAD_ROWS:
        obj = {"model": "churn", "row": row, "variant": variant}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj) and "error" in mine


@pytest.mark.parametrize("line", [
    b"this is not json\n", b'{"model": "nope", "row": "a,b"}\n',
    b'{"model": "churn"}\n', b'{"cmd": "nope"}\n', b"[1, 2]\n",
    b'{"model": "churn", "row": "X1,planA", "variant": "f16"}\n'])
def test_malformed_requests_match_reference(servers, line):
    (_, port), (_, ref) = servers
    import socket

    def raw(p):
        with socket.create_connection((HOST, p), timeout=30) as sock:
            sock.sendall(line)
            buf = b""
            while not buf.endswith(b"\n"):
                buf += sock.recv(65536)
        resp = json.loads(buf)
        resp.pop("trace_id", None)
        return resp

    mine = raw(port)
    assert "error" in mine
    assert mine == raw(ref)


def test_warmup_leaves_no_builds_for_traffic(servers, arts):
    """Warmup built every bucket's scorer on each replica: request sizes
    1-16 under both variants build nothing new, and hit the cache."""
    (srv, port), _ = servers
    groups = srv.pool.variant_groups("churn")
    counters = [r.entry.counters for g in groups for r in g.replicas]
    assert all(c.get(SERVE_GROUP, "Warmup buckets") == 7 for c in counters)
    before = [c.get(SERVE_GROUP, "Scorer compilations") for c in counters]
    hits = sum(c.get(SERVE_GROUP, "Scorer cache hits") for c in counters)
    assert all(b == 7 for b in before)
    compiles = telemetry.get_metrics().counters.get(
        telemetry.TELEMETRY_GROUP, telemetry.COMPILE_COUNT)
    for variant in ("f32", "f64"):
        for size in range(1, 17):
            resp = _ask(port, {"model": "churn", "variant": variant,
                               "rows": arts["test"][:size]})
            assert resp["outputs"] == arts["batch"][variant][:size]
    assert [c.get(SERVE_GROUP, "Scorer compilations")
            for c in counters] == before
    assert sum(c.get(SERVE_GROUP, "Scorer cache hits")
               for c in counters) > hits
    assert telemetry.get_metrics().counters.get(
        telemetry.TELEMETRY_GROUP, telemetry.COMPILE_COUNT) == compiles


def test_concurrent_clients_over_two_replicas(servers, arts):
    """16 client threads against two replicas per variant: every response
    byte-correct (the built scorer is shared and reentrant)."""
    (srv, port), _ = servers
    test, batch = arts["test"][:192], arts["batch"]
    failures = []

    def client(t):
        variant = ("f32", "f64")[t % 2]
        for i in range(t, len(test), 16):
            if i % 5 == 0:
                rows = test[i:i + 3]
                resp = request(HOST, port, {"model": "churn", "variant":
                                            variant, "rows": rows})
                if resp.get("outputs") != batch[variant][i:i + len(rows)]:
                    failures.append((t, i, resp))
            else:
                resp = request(HOST, port, {"model": "churn", "variant":
                                            variant, "row": test[i]})
                if resp.get("output") != batch[variant][i]:
                    failures.append((t, i, resp))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, failures[:3]
    for group in srv.pool.variant_groups("churn"):
        assert len(group.replicas) == 2
        for rep in group.replicas:
            assert rep.device == torch.device("cpu")
            assert all(t.device == rep.device
                       for t in rep.entry.adapter.tensors())


# ---------------------------------------------------------------------------
# kNN: the reference's one-unit contract
# ---------------------------------------------------------------------------

def test_knn_responses_match_reference(servers, arts):
    (srv, port), (ref_srv, ref) = servers
    rows = arts["knn_test"]
    obj = {"model": "neighbors", "rows": rows}
    mine, theirs = _ask(port, obj), _ask(ref, obj)
    assert mine["outputs"] and None not in mine["outputs"]
    # neighbor distances within one unit, the same neighbors where the
    # distances agree (ops/distance.py's contract); at this scale no
    # distance lands on a rounding boundary, so the votes agree too
    pa = srv.pool.variant_groups("neighbors")[0].replicas[0].entry.adapter
    ra = ref_srv.registry.get("neighbors").adapter
    recs = [r.split(",") for r in rows]
    qn, qc, _, _ = pa.sts._encode(recs, pa.vocabs)
    pd, pi = pa._distances(qn, qc)
    rqn, rqc, _, _ = ra.sts._encode(recs, ra.vocabs)
    rd, ri = ra._distances(rqn, rqc)
    assert np.abs(np.asarray(pd, np.int64) - np.asarray(rd)).max() <= 1
    same = np.asarray(pd) == np.asarray(rd)
    assert (np.asarray(pi)[same] == np.asarray(ri)[same]).all()
    assert mine == theirs
    single = _ask(port, {"model": "neighbors", "row": rows[3]})
    assert single["output"] == mine["outputs"][3]


def test_knn_training_set_is_resident(servers):
    (srv, _), _ = servers
    for rep in srv.pool.variant_groups("neighbors")[0].replicas:
        ad = rep.entry.adapter
        ptrs = [t.data_ptr() for t in ad.tensors()]
        ad.predict_lines(["Q,1.0,2.0,N", "R,8.0,1.0,Y"])
        assert [t.data_ptr() for t in ad.tensors()] == ptrs
        assert ad.device_bytes() == 90 * 2 * 4


# ---------------------------------------------------------------------------
# load-time refusals and device selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["banditDecision"])
def test_unported_kind_is_refused_at_load(arts, kind):
    props = _props(arts, **{"serve.models": "m", "serve.model.m.kind": kind})
    with pytest.raises(NotImplementedError, match=f"{kind}.*not ported"):
        PredictionServer(JobConfig(props), device="cpu")
    assert kind in jengine.ADAPTER_KINDS and kind not in engine.ADAPTER_KINDS
    with pytest.raises(ValueError, match="unknown model kind"):
        ModelRegistry(JobConfig({"serve.model.m.kind": "bogus"})).describe(
            "m")


def _field(**kw):
    f = {"name": "f", "ordinal": 1, "feature": True}
    f.update(kw)
    return {"fields": [{"name": "id", "ordinal": 0, "id": True,
                        "dataType": "string"}, f,
                       {"name": "c", "ordinal": 2, "dataType": "categorical",
                        "cardinality": ["N", "Y"]}]}


@pytest.mark.parametrize("schema", [
    _field(dataType="categorical"),
    _field(dataType="categorical", cardinality=["a", "b"]),
    _field(dataType="int", bucketWidth=10),
    _field(dataType="int", bucketWidth=10, min=0),
    _field(dataType="int", bucketWidth=10, max=100),
    _field(dataType="int", bucketWidth=10, min=-5, max=100),
    _field(dataType="int", bucketWidth=10, min=0, max=100),
    _field(dataType="int"),
], ids=lambda s: json.dumps(s["fields"][1], sort_keys=True))
def test_require_declared_schema_matches_reference(schema):
    def verdict(fn, schema_obj):
        try:
            fn(schema_obj)
        except ValueError as e:
            return str(e)
        return None

    mine = verdict(engine._require_declared_schema,
                   FeatureSchema.from_json(json.dumps(schema)))
    theirs = verdict(jengine._require_declared_schema,
                     JaxSchema.from_json(json.dumps(schema)))
    assert mine == theirs


def test_server_asks_for_cuda_without_a_device(arts, monkeypatch):
    """No ``device``: the server asks for cuda:0, and fails with no card
    (checked with a patched device probe, not a card)."""
    props = JobConfig(_props(arts, **{"serve.models": "churn"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictionServer(props)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    asked = []

    def build(self, name, variant="default", counters=None, device=None):
        asked.append(device)
        raise RuntimeError("stop here")

    monkeypatch.setattr(ModelRegistry, "build", build)
    with pytest.raises(RuntimeError, match="stop here"):
        PredictionServer(props)
    assert asked == [torch.device("cuda", 0)]


def test_serve_cli_refuses_without_models(capsys):
    from avenir_tpu_torch import cli
    assert cli.main(["serve", "--device", "cpu"]) == 2
    assert "no models configured" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# launch counters and build accounting under concurrency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,name", [
    ("topk", "K3_LAUNCHES"), ("topk", "MERGE_LAUNCHES"),
    ("histogram", "K1_LAUNCHES"), ("histogram", "K2_LAUNCHES")])
def test_launch_counters_lose_no_count_across_threads(module, name):
    """Two replicas' batcher threads may launch at once: the counters
    add under a lock.  The wrappers' plain path (CPU tensors) never
    counts, from any number of threads."""
    import importlib
    import sys

    from avenir_tpu_torch.ops.topk import fused_pairwise_topk

    mod = importlib.import_module(f"avenir_tpu_torch.ops.{module}")
    mod.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(20000):
                mod._count_launch(name)

        threads = [threading.Thread(target=bump) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert getattr(mod, name) == 40000
    mod.reset_launch_counts()

    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.random((9, 4), dtype=np.float32))
    t = torch.from_numpy(rng.random((70, 4), dtype=np.float32))
    qc, tc = torch.zeros((9, 0), dtype=torch.int32), \
        torch.zeros((70, 0), dtype=torch.int32)
    w = torch.zeros(0, dtype=torch.float32)
    want = fused_pairwise_topk(q, qc, t, tc, w, 4.0, 1000, 5)
    got = [None, None]

    def plain(i):
        got[i] = fused_pairwise_topk(q, qc, t, tc, w, 4.0, 1000, 5)

    threads = [threading.Thread(target=plain, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    assert getattr(mod, name) == 0


def test_profiled_build_bills_the_first_call_once():
    counters = telemetry.get_metrics().counters
    before = counters.get(telemetry.TELEMETRY_GROUP, telemetry.COMPILE_COUNT)
    calls = []
    fn = telemetry.profiled_build(lambda x: calls.append(x) or x * 2, "t")
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert fn(21) == 42 and len(calls) == 9
    assert counters.get(telemetry.TELEMETRY_GROUP,
                        telemetry.COMPILE_COUNT) == before + 1
    # the CPU holds no device memory: nothing to sample, no gauge
    telemetry.watch_device("cpu")
    assert telemetry.sample_device_memory(force=True) is None


# ---------------------------------------------------------------------------
# the Markov log-odds classifier (tests/test_serve.py:223,
# tests/test_pool.py:213): byte parity with the reference and the batch job
# ---------------------------------------------------------------------------

MARKOV_STATES = ["LL", "LM", "LH", "ML", "MM", "MH", "HL", "HM", "HH"]
# rows that fail per row: an unknown state, and two records too short to
# hold a transition
MARKOV_BAD_ROWS = ["B1,L,LL,XX,HH", "B2,C,LL", "B3"]


def _markov_chain(diag):
    S = len(MARKOV_STATES)
    T = np.full((S, S), (1 - diag) / (S - 1))
    np.fill_diagonal(T, diag)
    return T


@pytest.fixture(scope="module")
def markov(tmp_path_factory):
    """tests/test_serve.py's Markov artifact (300 sequences, seed 9, 200
    trained), trained by the port, and the port's batch classifier lines
    for the other 100 under both precisions."""
    tmp = tmp_path_factory.mktemp("torch_serve_markov")
    seqs = [",".join(r) for r in gen_state_sequences(
        300, MARKOV_STATES, {"L": _markov_chain(0.6),
                             "C": _markov_chain(0.15)},
        seq_len=(15, 40), seed=9)]
    jax_write_output(str(tmp / "train"), seqs[:200])
    jax_write_output(str(tmp / "test"), seqs[200:])
    MarkovStateTransitionModel(JobConfig({
        "model.states": ",".join(MARKOV_STATES),
        "class.label.field.ord": "1", "skip.field.count": "1",
        "trans.prob.scale": "1000"}), device="cpu").run(
        str(tmp / "train"), str(tmp / "model"))
    props = {"mm.model.path": str(tmp / "model"),
             "class.label.based.model": "true", "class.labels": "L,C",
             "validation.mode": "true", "class.label.field.ord": "1",
             "skip.field.count": "1"}
    batch = {}
    for variant, precision in (("f32", "float32"), ("f64", "float64")):
        out = str(tmp / f"pred_{variant}")
        MarkovModelClassifier(JobConfig(dict(
            props, **{"mmc.score.precision": precision})),
            device="cpu").run(str(tmp / "test"), out)
        with open(os.path.join(out, "part-r-00000")) as fh:
            batch[variant] = fh.read().splitlines()
    assert batch["f32"] != batch["f64"]        # the variants differ
    return {"props": props, "test": seqs[200:], "batch": batch}


def _markov_props(markov, **over):
    props = {"serve.models": "seg", "serve.model.seg.kind": "markovClassifier",
             "serve.model.seg.variants": "f32,f64",
             "serve.pool.replicas": "2", "serve.batch.max.size": "64",
             "serve.batch.max.delay.ms": "2", "serve.queue.max.depth": "256",
             "serve.port": "0"}
    for k, v in markov["props"].items():
        props[f"serve.model.seg.{k}"] = v
    props.update(over)
    return props


@pytest.fixture(scope="module")
def markov_servers(markov):
    port_srv = PredictionServer(JobConfig(_markov_props(markov)),
                                device="cpu")
    ref_srv = JaxServer(JaxConfig(_markov_props(markov)))
    try:
        yield (port_srv, port_srv.start()), (ref_srv, ref_srv.start())
    finally:
        port_srv.stop()
        ref_srv.stop()


@pytest.mark.parametrize("variant", ["f32", "f64"])
def test_markov_responses_match_reference_and_batch(markov_servers, markov,
                                                    variant):
    """Over TCP, in batches that cross every row bucket and one row at a
    time: the reference server's response and the batch line."""
    (_, port), (_, ref) = markov_servers
    test, batch = markov["test"], markov["batch"][variant]
    lo = 0
    for size in (64, 1, 2, 3, 5, 8, 13, 4):
        obj = {"model": "seg", "rows": test[lo:lo + size],
               "variant": variant}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj)
        assert mine["variant"] == variant
        assert mine["outputs"] == batch[lo:lo + size]
        lo += size
    for i in (0, 57, 99):
        obj = {"model": "seg", "row": test[i], "variant": variant}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj) and mine["output"] == batch[i]


@pytest.mark.parametrize("variant", ["f32", "f64"])
def test_markov_per_row_errors_match_reference(markov_servers, markov,
                                               variant):
    (_, port), (_, ref) = markov_servers
    rows = MARKOV_BAD_ROWS + markov["test"][:3] + MARKOV_BAD_ROWS[:1]
    obj = {"model": "seg", "rows": rows, "variant": variant}
    mine = _ask(port, obj)
    assert mine == _ask(ref, obj)
    assert mine["errors"] == len(MARKOV_BAD_ROWS) + 1
    assert mine["outputs"][len(MARKOV_BAD_ROWS):len(MARKOV_BAD_ROWS) + 3] \
        == markov["batch"][variant][:3]
    for row in MARKOV_BAD_ROWS:
        obj = {"model": "seg", "row": row, "variant": variant}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj) and "error" in mine


def test_markov_warmup_leaves_no_builds_for_traffic(markov_servers, markov):
    """Warmup built every (row bucket, length bucket) scorer on each
    replica: 7 row buckets x the default length buckets 16 and 64; traffic
    of 1-16 rows under both variants builds nothing new."""
    (srv, port), _ = markov_servers
    groups = srv.pool.variant_groups("seg")
    counters = [r.entry.counters for g in groups for r in g.replicas]
    assert all(c.get(SERVE_GROUP, "Warmup buckets") == 7 for c in counters)
    before = [c.get(SERVE_GROUP, "Scorer compilations") for c in counters]
    assert all(b == 14 for b in before)
    for variant in ("f32", "f64"):
        for size in range(1, 17):
            resp = _ask(port, {"model": "seg", "variant": variant,
                               "rows": markov["test"][:size]})
            assert resp["outputs"] == markov["batch"][variant][:size]
    assert [c.get(SERVE_GROUP, "Scorer compilations")
            for c in counters] == before


def test_markov_concurrent_clients_over_two_replicas(markov_servers, markov):
    (srv, port), _ = markov_servers
    test, batch = markov["test"], markov["batch"]
    failures = []

    def client(t):
        variant = ("f32", "f64")[t % 2]
        for i in range(t, len(test), 16):
            resp = request(HOST, port, {"model": "seg", "variant": variant,
                                        "row": test[i]})
            if resp.get("output") != batch[variant][i]:
                failures.append((t, i, resp))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, failures[:3]


def test_markov_tables_live_on_the_replica_device(markov_servers):
    """markovClassifier loads (no refusal); each replica's log-ratio table
    is on its device, 9 x 9 in the variant's precision."""
    (srv, _), _ = markov_servers
    for group in srv.pool.variant_groups("seg"):
        dt = {"f32": torch.float32, "f64": torch.float64}[group.variant]
        for rep in group.replicas:
            ad = rep.entry.adapter
            assert ad.KIND == "markovClassifier" == engine.MarkovClassifierAdapter.KIND
            (table,) = ad.tensors()
            assert table.device == rep.device == torch.device("cpu")
            assert table.dtype == dt and tuple(table.shape) == (9, 9)
            assert ad.device_bytes() == 81 * table.element_size()
            ptr = table.data_ptr()
            ad.predict_lines(["Q,L,LL,LM,HH,HH"])
            assert ad.tensors()[0].data_ptr() == ptr


def test_markov_adapter_length_buckets(markov):
    """Lengths past the largest configured bucket fall back to powers of
    two, and the scores keep their bits there too."""
    cfg = JobConfig(dict(markov["props"], **{"seq.buckets": "4,8"}))
    ad = engine.MarkovClassifierAdapter(cfg, Counters(), device="cpu")
    assert [ad._len_bucket(n) for n in (1, 4, 5, 8, 9, 40)] == \
        [4, 4, 8, 8, 16, 64]
    want = markov["batch"]["f64"][:5]
    assert ad.predict_lines(markov["test"][:5]) == want


# ---------------------------------------------------------------------------
# decision tree: a tree the reference built, served by both servers
# ---------------------------------------------------------------------------

TREE_SCHEMA = os.path.join(REPO, "resource", "decision_tree", "retarget.json")
# a category outside the schema's, a cart amount that does not parse, and a
# record too short to hold the split attributes
TREE_BAD_ROWS = ["T1,9Z,120,N", "T2,1C,12x,Y", "T3"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """resource/decision_tree's configuration on 400 retarget rows (seed
    31), grown three levels by the reference, and 120 fresh rows."""
    tmp = tmp_path_factory.mktemp("torch_serve_tree")
    rows = [",".join(r) for r in gen_retarget(400, seed=31)]
    jax_write_output(str(tmp / "in"), rows)
    builder = jtree.DecisionTreeBuilder(JaxConfig({
        "feature.schema.file.path": TREE_SCHEMA,
        "decision.file.path": str(tmp / "decpath.json"),
        "split.algorithm": "entropy", "path.stopping.strategy": "maxDepth",
        "max.depth.limit": "2", "sub.sampling.strategy": "none",
        "seed": "11"}))
    builder.run_loop(str(tmp / "in"), str(tmp / "levels"), max_levels=3)
    test = [",".join(r) for r in gen_retarget(120, seed=5)]
    return {"decpath": str(tmp / "decpath.json"), "test": test}


def _tree_props(tree):
    return {"serve.models": "tree", "serve.model.tree.kind": "decisionTree",
            "serve.model.tree.feature.schema.file.path": TREE_SCHEMA,
            "serve.model.tree.decision.file.path": tree["decpath"],
            "serve.pool.replicas": "2", "serve.batch.max.size": "64",
            "serve.batch.max.delay.ms": "2", "serve.port": "0"}


@pytest.fixture(scope="module")
def tree_servers(tree):
    port_srv = PredictionServer(JobConfig(_tree_props(tree)), device="cpu")
    ref_srv = JaxServer(JaxConfig(_tree_props(tree)))
    try:
        yield (port_srv, port_srv.start()), (ref_srv, ref_srv.start())
    finally:
        port_srv.stop()
        ref_srv.stop()


def _routed(tree, rows):
    """Each row's first leaf path whose every predicate it satisfies, from
    the decision path list itself: ``id,path,population,infoContent``."""
    schema = FeatureSchema.from_file(TREE_SCHEMA)
    dpl = DecisionPathList.from_file(tree["decpath"])
    recs = [r.split(",") for r in rows]
    out = []
    for rec in recs:
        line = None
        for leaf in dpl.paths:
            preds = [AttributePredicate.parse(
                ps, schema.field_by_ordinal(int(ps.split()[0])))
                for ps in leaf.predicate_strs if ps != "$root"]
            cols = {p.attr: _column([rec], schema.field_by_ordinal(p.attr))
                    for p in preds}
            if all(predicate_matrix([p], cols)[0, 0] for p in preds):
                line = ",".join([rec[0], leaf.path_str, str(leaf.population),
                                 repr(leaf.info_content)])
                break
        out.append(line)
    return out


def test_tree_responses_match_reference_and_routing(tree_servers, tree):
    (_, port), (_, ref) = tree_servers
    test = tree["test"]
    want = _routed(tree, test)
    assert sum(w is not None for w in want) > 100
    lo = 0
    for size in (64, 1, 2, 3, 5, 8, 13, 24):
        obj = {"model": "tree", "rows": test[lo:lo + size]}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj)
        assert mine["outputs"] == want[lo:lo + size]
        lo += size
    for i in (0, 33, 119):
        obj = {"model": "tree", "row": test[i]}
        mine = _ask(port, obj)
        assert mine == _ask(ref, obj) and mine["output"] == want[i]


def test_tree_malformed_rows_leave_their_batch_unharmed(tree_servers, tree):
    (_, port), (_, ref) = tree_servers
    good = tree["test"][:4]
    rows = [good[0]] + TREE_BAD_ROWS + good[1:]
    obj = {"model": "tree", "rows": rows}
    mine = _ask(port, obj)
    assert mine == _ask(ref, obj)
    want = _routed(tree, good)
    outs = mine["outputs"]
    assert [outs[0]] + outs[1 + len(TREE_BAD_ROWS):] == want
    assert mine["errors"] == len(TREE_BAD_ROWS)
    for row in TREE_BAD_ROWS:
        one = _ask(port, {"model": "tree", "row": row})
        assert one == _ask(ref, {"model": "tree", "row": row})
        assert "error" in one


def test_tree_adapter_is_a_host_adapter(tree):
    ad = engine.adapter_class("decisionTree")(
        JobConfig({"feature.schema.file.path": TREE_SCHEMA,
                   "decision.file.path": tree["decpath"]}),
        Counters(), device="cpu")
    assert isinstance(ad, engine.DecisionTreeAdapter)
    assert ad.device_bytes() == 0
    assert ad.predict_lines(tree["test"][:7]) == _routed(tree,
                                                        tree["test"][:7])
    assert engine.UNPORTED_KINDS == ("banditDecision",)
