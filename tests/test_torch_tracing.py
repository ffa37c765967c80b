"""The port's batch-job spans on the CPU: ``ingest.parse`` around the
native encode itself, the job's set-up (``cli.prepare``), the chunk split
(``ingest.split``), the model text (``model.lines``), the fold's waits
for chunks (``ingest.wait``), the collector's passes (``host.gc``), the
Markov trainer's ingest spans, and the Chrome export's wall-clock anchor
that lays a ``--trace`` file over the ``--profile-dir`` trace of the same
job.

Input: 4,000 seeded churn rows in 256-row chunks (16 chunks).
"""

import gc
import json
import os
import threading
import time
from collections import Counter

import pytest

from avenir_tpu_torch import datagen, native
from avenir_tpu_torch.cli import main as cli_main
from avenir_tpu_torch.core import obs
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import write_output
from avenir_tpu_torch.models import bayesian as tb
from avenir_tpu_torch.models import markov as tm

SCHEMA = {"fields": [
    {"name": "custId", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "plan", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["planA", "planB", "planC"]},
    {"name": "minUsed", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 2800, "bucketWidth": 400},
    {"name": "dataUsed", "ordinal": 3, "dataType": "int", "feature": True,
     "min": 0, "max": 1800, "bucketWidth": 300},
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
#: how long the patched native encode sleeps a call
SLEEP_S = 0.01
#: the clock check's tolerance, ns
TOL_NS = 1_000_000


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    obs.configure(enabled=False)
    obs.get_tracer().clear()


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tracing")
    rows = datagen.gen_telecom_churn(N_ROWS, seed=5)
    (tmp / "in.csv").write_text("\n".join(",".join(r) for r in rows) + "\n")
    (tmp / "schema.json").write_text(json.dumps(SCHEMA))
    return {"in": str(tmp / "in.csv"), "schema": str(tmp / "schema.json")}


def _props(churn, **extra):
    props = {"feature.schema.file.path": churn["schema"],
             "pipeline.chunk.rows": str(CHUNK_ROWS)}
    props.update({k: str(v) for k, v in extra.items()})
    return props


def _cli(churn, out, *flags, **extra):
    argv = ["BayesianDistribution"]
    argv += [f"-D{k}={v}" for k, v in _props(churn, **extra).items()]
    argv += [churn["in"], str(out), "--device", "cpu", *flags]
    return cli_main(argv)


def _root(span, by_id):
    """The outermost recorded ancestor of ``span``."""
    while span.parent_id in by_id:
        span = by_id[span.parent_id]
    return span


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("threads", [1, 4])
def test_parse_span_holds_the_native_encode(churn, tmp_path, monkeypatch,
                                            threads, depth):
    """Each chunk's native encode call lies inside one ``ingest.parse``
    span on the thread that made the call: the main thread for chunk 0
    (the first-chunk peek) at one parse thread, a pool worker at four."""
    calls = []
    real = native.encode_schema_buffer

    def slow(*args, **kwargs):
        t0 = time.perf_counter_ns()
        time.sleep(SLEEP_S)
        res = real(*args, **kwargs)
        calls.append((threading.get_ident(), t0, time.perf_counter_ns()))
        return res

    monkeypatch.setattr(native, "encode_schema_buffer", slow)
    tr = obs.configure(enabled=True)
    tr.clear()
    tb.BayesianDistribution(JobConfig(_props(
        churn, **{"ingest.parse.threads": threads,
                  "pipeline.prefetch.depth": depth})), device="cpu").run(
        churn["in"], str(tmp_path / "out"))
    parse = tr.spans("ingest.parse")
    assert len(calls) == N_CHUNKS
    holders = []
    for tid, a, b in sorted(calls, key=lambda c: c[1]):
        mine = [s for s in parse if s.tid == tid and s.t0_ns <= a
                and b <= s.t0_ns + s.dur_ns]
        assert len(mine) == 1, (tid, a, b)
        holders.append(mine[0])
    assert all(s.dur_ns >= SLEEP_S * 1e9 for s in holders)
    if threads == 1:
        assert holders[0].thread == "MainThread"
    else:
        assert all(s.thread.startswith("parse-pool-") for s in holders)
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    assert all(_root(s, by_id).name == "job:BayesianDistribution"
               for s in parse)


@pytest.mark.parametrize("depth", [0, 2])
def test_job_spans_once_per_job_in_its_tree(churn, tmp_path, depth):
    """Two jobs through the command line: each records one
    ``cli.prepare`` (the job span's first child, ending before the job
    span opens), one ``ingest.split`` and one ``model.lines``, and with
    prefetch an ``ingest.wait`` a chunk, all in the job's tree."""
    tr = obs.get_tracer()
    tr.clear()
    for k in range(2):
        assert _cli(churn, tmp_path / f"out{k}", **{
            "obs.trace.enable": "true",
            "pipeline.prefetch.depth": depth}) == 0
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    jobs = [s for s in spans if s.name == "job:BayesianDistribution"]
    assert len(jobs) == 2
    for job in jobs:
        tree = [s for s in spans if s is not job and _root(s, by_id) is job]
        n = Counter(s.name for s in tree)
        assert n["cli.prepare"] == n["ingest.split"] == n["model.lines"] == 1
        assert n["ingest.wait"] == (N_CHUNKS if depth else 0)
        prep = next(s for s in tree if s.name == "cli.prepare")
        assert prep.parent_id == job.span_id
        assert prep.t0_ns + prep.dur_ns <= job.t0_ns
        lines = next(s for s in tree if s.name == "model.lines")
        emit = next(s for s in tree if s.name == "phase:emit")
        assert lines.t0_ns + lines.dur_ns <= emit.t0_ns
        split = next(s for s in tree if s.name == "ingest.split")
        assert by_id[split.parent_id].name == "phase:train"
        assert all(by_id[s.parent_id].name == "phase:train"
                   for s in tree if s.name == "ingest.wait")


def test_gc_pass_is_a_host_gc_span():
    """A forced generation-1 pass under the enabled tracer is one
    ``host.gc`` span under the thread's open span; generation 0 is left
    out; disabled, the hook is not installed."""
    tr = obs.configure(enabled=True)
    assert obs._gc_hook in gc.callbacks
    gc.disable()           # no pass but the forced ones
    try:
        tr.clear()
        with tr.span("outer") as outer:
            gc.collect(1)
        gc.collect(0)
        got = tr.spans("host.gc")
        assert [s.attrs["generation"] for s in got] == [1]
        assert got[0].parent_id == outer.span_id
        assert got[0].dur_ns > 0
        obs.configure(enabled=False)
        assert obs._gc_hook not in gc.callbacks
        gc.collect(2)
        assert len(tr.spans("host.gc")) == 1
    finally:
        gc.enable()


def test_gc_pass_under_the_tracer_lock_completes():
    """A pass that starts while its thread holds the tracer's lock hands
    its record off instead of taking the lock again."""
    tr = obs.configure(enabled=True)
    gc.disable()
    try:
        tr.clear()
        done = threading.Event()

        def locked_pass():
            with tr._lock:
                gc.collect(2)
            done.set()

        t = threading.Thread(target=locked_pass, daemon=True)
        t.start()
        t.join(30)
        assert done.is_set()
        assert [s.attrs["generation"] for s in tr.spans("host.gc")] == [2]
    finally:
        gc.enable()


def test_trace_and_profile_lie_on_one_timeline(churn, tmp_path):
    """``--trace`` and ``--profile-dir`` on one job: with each file's
    ``baseTimeNanoseconds`` applied, every ``aten::`` event of the
    profile lies inside the exported ``job:BayesianDistribution`` span
    and each ``ingest.fold`` span holds the fold's events, within 1 ms."""
    trace, prof = tmp_path / "trace.json", tmp_path / "prof"
    assert _cli(churn, tmp_path / "out", "--trace", str(trace),
                f"--profile-dir={prof}") == 0
    with open(trace) as fh:
        ours = json.load(fh)
    (name,) = os.listdir(prof)
    with open(prof / name) as fh:
        theirs = json.load(fh)

    def unix(ev, base):
        a = base + ev["ts"] * 1000
        return a, a + ev.get("dur", 0) * 1000

    base = ours["baseTimeNanoseconds"]
    (job,) = [unix(e, base) for e in ours["traceEvents"]
              if e.get("name") == "job:BayesianDistribution"]
    folds = [unix(e, base) for e in ours["traceEvents"]
             if e.get("name") == "ingest.fold"]
    aten = [unix(e, theirs["baseTimeNanoseconds"])
            for e in theirs["traceEvents"]
            if e.get("ph") == "X" and str(e.get("name")).startswith("aten::")]
    assert len(folds) == N_CHUNKS and aten
    assert all(job[0] - TOL_NS <= a and b <= job[1] + TOL_NS
               for a, b in aten)
    for fa, fb in folds:
        assert any(fa - TOL_NS <= a and b <= fb + TOL_NS for a, b in aten)


STATES = ["A", "B", "C"]
CHAIN = [[0.6, 0.2, 0.2], [0.2, 0.6, 0.2], [0.2, 0.2, 0.6]]


@pytest.mark.parametrize("chunk_rows", [None, 64], ids=["whole", "chunked"])
def test_markov_trainer_ingest_spans(tmp_path, chunk_rows):
    """The Markov trainer's read, parse (split, labels, encode) and fold
    are ``ingest.*`` spans in its job's tree, once on the whole input
    and once a chunk on the chunked path."""
    rows = datagen.gen_state_sequences(300, STATES, {"L": CHAIN, "C": CHAIN},
                                       seq_len=(5, 12), seed=9)
    write_output(str(tmp_path / "in"), [",".join(r) for r in rows])
    props = {"model.states": ",".join(STATES), "class.label.field.ord": "1",
             "skip.field.count": "1"}
    if chunk_rows:
        props["pipeline.chunk.rows"] = str(chunk_rows)
    tr = obs.configure(enabled=True)
    tr.clear()
    tm.MarkovStateTransitionModel(JobConfig(props), device="cpu").run(
        str(tmp_path / "in"), str(tmp_path / "out"))
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    n = Counter(s.name for s in spans)
    want = 1 if chunk_rows is None else -(-300 // chunk_rows)
    for name in ("ingest.read", "ingest.parse", "ingest.fold"):
        assert n[name] == want, name
        assert all(_root(s, by_id).name == "job:MarkovStateTransitionModel"
                   for s in spans if s.name == name)


KNN_SPANS = ("ingest.read", "ingest.parse", "knn.distance", "knn.emit")


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["native", "python"])
def test_knn_jobs_record_their_spans(tmp_path, monkeypatch, columnar):
    """The distance job records ``ingest.read``, ``ingest.parse``,
    ``knn.distance`` and ``knn.emit``, and the vote job ``ingest.read``,
    ``ingest.parse`` and ``knn.vote``, each once and inside its own job
    span, on the native reader and on the Python one; ``knn.emit``'s
    ``columnar`` says which emit the reader's sets took."""
    from avenir_tpu_torch.models import knn as tk

    rows = datagen.gen_elearn(120, seed=3)
    inp = tmp_path / "in"
    inp.mkdir()
    (inp / "tr-00000").write_text("\n".join(",".join(r) for r in rows[:100]))
    (inp / "te-00000").write_text("\n".join(",".join(r) for r in rows[100:]))
    schema = os.path.join(os.path.dirname(__file__), "..", "resource",
                          "elearn_nb", "elearn.json")
    if not columnar:
        monkeypatch.setattr(tk.SameTypeSimilarity, "_read_columns",
                            lambda self, *a: None)
    tr = obs.configure(enabled=True)
    tr.clear()
    tk.SameTypeSimilarity(JobConfig({
        "feature.schema.file.path": schema, "output.top.matches": "3"}),
        device="cpu").run(str(inp), str(tmp_path / "sim"))
    tk.NearestNeighbor(JobConfig({
        "feature.schema.file.path": schema, "top.match.count": "3"}),
        device="cpu").run(str(tmp_path / "sim"), str(tmp_path / "pred"))
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    jobs = {"job:SameTypeSimilarity": KNN_SPANS,
            "job:NearestNeighbor": ("ingest.read", "ingest.parse",
                                    "knn.vote")}
    for job, names in jobs.items():
        (root,) = [s for s in spans if s.name == job]
        inside = Counter(s.name for s in spans
                         if s is not root and _root(s, by_id) is root)
        for name in names:
            assert inside[name] == 1, (job, name, inside)
            (s,) = [s for s in spans
                    if s.name == name and _root(s, by_id) is root]
            assert root.t0_ns <= s.t0_ns
            assert s.t0_ns + s.dur_ns <= root.t0_ns + root.dur_ns
    parse = [s for s in spans if s.name == "ingest.parse"
             and _root(s, by_id).name == "job:SameTypeSimilarity"]
    assert parse[0].attrs["native"] is columnar
    (emit,) = [s for s in spans if s.name == "knn.emit"]
    assert emit.attrs["columnar"] is columnar


@pytest.mark.parametrize("settings,ragged,columnar", [
    ({}, False, True),
    ({"decision.threshold": "1.2", "class.attribute.values": "F,P"},
     False, False),
    ({}, True, False)], ids=["cell", "threshold", "ragged"])
def test_vote_job_parse_span_names_its_reader(tmp_path, settings, ragged,
                                              columnar):
    """The vote job records ``ingest.read``, ``ingest.parse`` and
    ``knn.vote`` once each inside its job span, on the columnar path
    (the e-learning cell's settings) and on the per-group one (a
    decision threshold; a ragged pair line); ``ingest.parse`` carries
    ``columnar``, and ``COLUMNAR_VOTES`` counts the columnar job."""
    from avenir_tpu_torch.models import knn as tk

    lines = [f"T{i},Q{i // 5},{i % 7},{'PF'[i % 2]},{'PF'[i // 5 % 2]}"
             for i in range(60)]
    if ragged:
        lines[11] += ",extra"
    write_output(str(tmp_path / "sim"), lines)
    schema = os.path.join(os.path.dirname(__file__), "..", "resource",
                          "elearn_nb", "elearn.json")
    tr = obs.configure(enabled=True)
    tr.clear()
    before = tk.COLUMNAR_VOTES
    tk.NearestNeighbor(JobConfig(dict(settings, **{
        "feature.schema.file.path": schema, "top.match.count": "5",
        "validation.mode": "true", "kernel.function": "none"})),
        device="cpu").run(str(tmp_path / "sim"), str(tmp_path / "pred"))
    assert tk.COLUMNAR_VOTES - before == int(columnar)
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    (root,) = [s for s in spans if s.name == "job:NearestNeighbor"]
    inside = Counter(s.name for s in spans
                     if s is not root and _root(s, by_id) is root)
    for name in ("ingest.read", "ingest.parse", "knn.vote"):
        assert inside[name] == 1, (name, inside)
    (parse,) = [s for s in spans if s.name == "ingest.parse"]
    assert parse.attrs["columnar"] is columnar
    assert parse.attrs["rows"] == 60
