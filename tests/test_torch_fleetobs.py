"""The fleet observability plane's aggregator half in the port
(``avenir_tpu_torch/fleetobs``: ``aggregate``, ``stitch``, ``incidents``,
``aggregator``), held against the JAX package's on the same spools:

- ``fleet_fold`` of one snapshot set (three publishers, randomized
  publish interleavings) is byte-equal across packages and the exact sum
  of the processes;
- ``namespace_gauges``, ``parse_labels`` and ``FleetSLO`` equal the
  reference's;
- ``stitch_traces`` writes the reference's file from the same trace
  JSONL, and ``trace_tail`` reads the same records;
- ``IncidentCorrelator`` bundles the same dumps into the same files;
- the aggregator's stale-feed gauge and edge-triggered dump, and its
  merged scrape over TCP, equal to the exact sum of the per-process
  counters and to the reference aggregator's scrape.
"""

import json
import os
import random
import re
import shutil
import time

import pytest

from avenir_tpu.core import obs as jobs
from avenir_tpu.core import telemetry as jtelemetry
from avenir_tpu.core.config import JobConfig as JaxJobConfig
from avenir_tpu.fleetobs import aggregate as jaggregate
from avenir_tpu.fleetobs import stitch as jstitch
from avenir_tpu.fleetobs.aggregator import FleetAggregator as JaxAggregator
from avenir_tpu.fleetobs.identity import ProcessIdentity
from avenir_tpu.fleetobs.incidents import (
    IncidentCorrelator as JaxCorrelator)
from avenir_tpu.fleetobs.publisher import SpoolPublisher as JaxPublisher

from avenir_tpu_torch.core import flight, obs, telemetry
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import atomic_write_text
from avenir_tpu_torch.fleetobs import (FleetSLO, fleet_fold,
                                       namespace_gauges)
from avenir_tpu_torch.fleetobs.aggregate import parse_labels
from avenir_tpu_torch.fleetobs.aggregator import FleetAggregator
from avenir_tpu_torch.fleetobs.incidents import IncidentCorrelator
from avenir_tpu_torch.fleetobs.publisher import (FLIGHT_SUBDIR,
                                                 IDENTITY_FILE,
                                                 SNAPSHOT_FILE, TRACE_FILE,
                                                 SpoolPublisher)
from avenir_tpu_torch.fleetobs.stitch import (feed_dirs, stitch_traces,
                                              trace_tail)
from avenir_tpu_torch.serve.frontend import EventLoopFrontend
from avenir_tpu_torch.serve.server import request_text

TRACE_ID = "cafe0123deadbeef"


def _identity(role: str, i: int) -> ProcessIdentity:
    return ProcessIdentity(role=role, host="testhost", pid=1000 + i,
                           start_ns=i + 1,
                           trace_epoch_unix_ns=1_000_000_000 + i)


def _read_feeds(spool):
    feeds = {}
    for d in feed_dirs(spool):
        with open(os.path.join(d, SNAPSHOT_FILE)) as fh:
            feeds[os.path.basename(d)] = json.load(fh)["snapshot"]
    return feeds


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True)


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [20260806, 7])
def test_fleet_fold_equals_the_reference_under_interleaving(tmp_path, seed):
    """``tests/test_fleetobs.py:71``'s interleaved publishes (the port's
    publishers, the port's registries): the port's fold and the
    reference's fold of the same feeds are the same document, every
    counter and histogram the exact per-process sum, every process's
    gauge under its own ``proc`` label."""
    rng = random.Random(seed)
    spool = str(tmp_path)
    hist = telemetry.labeled("serve.e2e.latency", model="m")
    pubs, regs, want = [], [], {}
    for i in range(3):
        ident = _identity(f"r{i}", i)
        pubs.append(SpoolPublisher(spool, ident, tracer=obs.Tracer()))
        regs.append(obs.Metrics())
        want[ident.label] = {"requests": 0, "n": 0}
    for rnd in range(12):
        order = list(range(3))
        rng.shuffle(order)
        for i in order:
            label = pubs[i].identity.label
            k = rng.randrange(1, 7)
            regs[i].counters.incr("Serve.m", "Requests", k)
            want[label]["requests"] += k
            for _ in range(rng.randrange(0, 4)):
                regs[i].histogram(hist).record(rng.random() * 0.1)
                want[label]["n"] += 1
            regs[i].set_gauge("proc.queue.depth", i * 10 + rnd)
            pubs[i].publish(telemetry.build_snapshot(
                registry=regs[i], identity=pubs[i].identity.to_dict()))
    feeds = _read_feeds(spool)
    merged = fleet_fold(feeds)
    assert _canon(merged) == _canon(jaggregate.fleet_fold(feeds))
    assert merged["counters"]["Serve.m"]["Requests"] == sum(
        w["requests"] for w in want.values())
    assert merged["hists"][hist]["n"] == sum(w["n"] for w in want.values())
    for label in want:
        assert f'proc.queue.depth{{proc="{label}"}}' in merged["gauges"]
    assert "identity" not in merged


def test_fleet_fold_of_reference_published_feeds(tmp_path):
    """Feeds the reference's publisher wrote fold to the same document in
    both packages."""
    spool = str(tmp_path)
    for i in range(2):
        ident = _identity(f"j{i}", i)
        pub = JaxPublisher(spool, ident, tracer=jobs.Tracer())
        reg = jobs.Metrics()
        reg.counters.incr("Serve.churn", "Requests", 11 * (i + 1))
        reg.histogram(jtelemetry.labeled(
            "serve.e2e.latency", model="churn")).record(0.01 * (i + 1))
        reg.set_gauge("serve.queue.depth", float(i))
        pub.publish(jtelemetry.build_snapshot(registry=reg,
                                              identity=ident.to_dict()))
    feeds = _read_feeds(spool)
    assert _canon(fleet_fold(feeds)) == _canon(jaggregate.fleet_fold(feeds))


NAMESPACE_CASES = [
    {"gauges": {"plain": {"value": 1.0, "ts": 1.0},
                'lab{model="m"}': {"value": 2.0, "ts": 1.0}},
     "counters": {"G": {"n": 1}}, "hists": {}, "spans": {}},
    {"gauges": {'a{model="x",zone="y"}': {"value": 3.0, "ts": 2.0}},
     "counters": {}, "hists": {}},
    {"counters": {"G": {"n": 2}}},
]


@pytest.mark.parametrize("i", range(len(NAMESPACE_CASES)))
@pytest.mark.parametrize("label", ["p-1", "serve-host-77-abc"])
def test_namespace_gauges_equals_the_reference(i, label):
    snap = NAMESPACE_CASES[i]
    assert (_canon(namespace_gauges(snap, label))
            == _canon(jaggregate.namespace_gauges(snap, label)))


@pytest.mark.parametrize("labels", [
    {"model": 'we"ird\\name', "zone": "a"}, {"model": "m"},
    {"proc": "p-1", "model": "a,b"}, {"k": "x=y"}])
def test_parse_labels_equals_the_reference(labels):
    name = telemetry.labeled("g", **labels)
    m = telemetry._LABELED_RE.match(name)
    assert parse_labels(m.group(2)) == labels
    assert parse_labels(m.group(2)) == jaggregate.parse_labels(m.group(2))


def test_fleet_slo_equals_the_reference(tmp_path):
    """The fleet SLO board over one merged snapshot: the same windows
    and verdicts as the reference's."""
    hist = telemetry.labeled("serve.e2e.latency", model="churn")
    rng = random.Random(7)
    h = obs.LatencyHistogram()
    for _ in range(200):
        h.record(0.001 + rng.random() * 0.2)
    snap = {"hists": {hist: h.state_dict()},
            "counters": {"Serve.churn": {"Requests": 200}}}
    for target in ("1000", "50"):
        mine = FleetSLO(JobConfig({"serve.slo.p99.ms": target}))
        theirs = jaggregate.FleetSLO(JaxJobConfig(
            {"serve.slo.p99.ms": target}))
        assert _canon(mine.observe(snap)) == _canon(theirs.observe(snap))
        assert _canon(mine.verdicts()) == _canon(theirs.verdicts())
        assert _canon(mine.section()) == _canon(theirs.section())


# ---------------------------------------------------------------------------
# stitching and incidents
# ---------------------------------------------------------------------------

def _plant_trace_feed(spool, ident, spans) -> str:
    d = os.path.join(spool, ident.label)
    os.makedirs(os.path.join(d, FLIGHT_SUBDIR), exist_ok=True)
    atomic_write_text(os.path.join(d, IDENTITY_FILE),
                      json.dumps(ident.to_dict()))
    with open(os.path.join(d, TRACE_FILE), "w") as fh:
        for s in spans:
            fh.write(json.dumps(s) + "\n")
    return d


def _span(name, sid, parent, t0_ns, dur_ns, trace=TRACE_ID):
    return {"type": "span", "name": name, "id": sid, "parent": parent,
            "thread": "t0", "t0_ns": t0_ns, "dur_ns": dur_ns,
            "attrs": {"trace": trace}}


def _trace_spool(spool):
    a = _identity("gateway", 0)
    b = ProcessIdentity(role="scorer", host="testhost", pid=1001,
                        start_ns=2, trace_epoch_unix_ns=1_000_500_000)
    da = _plant_trace_feed(spool, a, [
        _span("serve.request", 1, None, 100_000, 900_000),
        _span("noise", 9, None, 0, 1, trace="other"),
        {"type": "gauge", "name": "q", "t_ns": 5, "value": 3}])
    db = _plant_trace_feed(spool, b, [_span("serve.score", 2, 1, 50_000,
                                            200_000)])
    return (a, da), (b, db)


@pytest.mark.parametrize("trace_id", [TRACE_ID, None, "absent"])
def test_stitch_traces_writes_the_reference_file(tmp_path, trace_id):
    spool = str(tmp_path / "spool")
    _trace_spool(spool)
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got = stitch_traces(spool, trace_id=trace_id, out_path=mine)
    want = jstitch.stitch_traces(spool, trace_id=trace_id, out_path=theirs)
    assert got == want
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    if trace_id == TRACE_ID:
        doc = json.load(open(mine))
        xs = {e["args"]["id"]: e for e in doc["traceEvents"]
              if e["ph"] == "X"}
        assert sorted(xs) == [1, 2] and xs[2]["ts"] == pytest.approx(550.0)


def test_trace_tail_and_feed_dirs_equal_the_reference(tmp_path):
    spool = str(tmp_path)
    (_, da), _ = _trace_spool(spool)
    os.makedirs(os.path.join(spool, "_incidents"))
    assert feed_dirs(spool) == jstitch.feed_dirs(spool)
    assert len(feed_dirs(spool)) == 2
    assert trace_tail(da, TRACE_ID) == jstitch.trace_tail(da, TRACE_ID)
    assert [r["id"] for r in trace_tail(da, TRACE_ID)] == [1]


def _plant_dump(feed_dir, reason, trace_id, stamp):
    tag = trace_id or stamp
    p = os.path.join(feed_dir, FLIGHT_SUBDIR, f"flight-{reason}-{tag}.jsonl")
    with open(p, "w") as fh:
        fh.write(json.dumps({"kind": "flight.header", "reason": reason,
                             "trace_id": trace_id, "ts": 1.5e9, "pid": 1,
                             "ring_records": 0}) + "\n")
        fh.write(json.dumps({"t": 0.0, "kind": "anomaly",
                             "reason": reason}) + "\n")


def _tree(root):
    """Every file under ``root`` by relative path, with ``root`` taken
    out of the text (a manifest names its files absolutely)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p).read().replace(
                root, "<root>")
    return out


def test_incident_bundles_equal_the_reference(tmp_path):
    """Dumps in two feeds sharing a trace id, plus an untraced one: the
    port's correlator and the reference's, each over its own copy of the
    spool, write the same bundles; a second scan bundles nothing."""
    trees = {}
    for tag, cls in (("port", IncidentCorrelator), ("jax", JaxCorrelator)):
        root = str(tmp_path / tag)
        spool = os.path.join(root, "spool")
        (a, da), (b, db) = _trace_spool(spool)
        _plant_dump(da, "deadline", TRACE_ID, "1")
        _plant_dump(db, "breaker_open", TRACE_ID, "2")
        _plant_dump(db, "unrelated", None, "1234567")
        corr = cls(os.path.join(root, "incidents"))
        feeds = {a.label: da, b.label: db}
        made = corr.scan(feeds)
        assert len(made) == 2
        assert corr.scan(feeds) == []
        trees[tag] = _tree(root)
    assert trees["port"] == trees["jax"]
    assert any("manifest.json" in k for k in trees["port"])


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

def _plant_feed(spool, ident, snapshot, published_unix):
    d = os.path.join(spool, ident.label)
    os.makedirs(d, exist_ok=True)
    atomic_write_text(os.path.join(d, IDENTITY_FILE),
                      json.dumps(ident.to_dict()))
    atomic_write_text(os.path.join(d, SNAPSHOT_FILE), json.dumps(
        {"seq": 1, "published_unix": published_unix,
         "label": ident.label, "snapshot": snapshot}))


def test_stale_feed_is_a_gauge_and_one_dump(tmp_path):
    spool = str(tmp_path / "spool")
    reg = obs.Metrics()
    reg.counters.incr("G", "n", 1)
    now = time.time()
    fresh, dead = _identity("fresh", 0), _identity("dead", 1)
    _plant_feed(spool, fresh, telemetry.build_snapshot(registry=reg), now)
    _plant_feed(spool, dead, telemetry.build_snapshot(registry=reg),
                now - 60.0)
    prev = flight.get_recorder()
    rec = flight.set_recorder(flight.FlightRecorder(
        dump_dir=str(tmp_path / "dumps"), min_interval_sec=0.0,
        snapshot_interval_sec=0))
    try:
        agg = FleetAggregator(spool, JobConfig({"fleetobs.stale.sec": "10"}))
        g = agg.scan(now=now)["gauges"]
        assert g["fleetobs.feeds"]["value"] == 2
        assert g["fleetobs.feeds.stale"]["value"] == 1
        assert g[f'fleetobs.feed.stale{{proc="{dead.label}"}}']["value"] == 1
        assert g[f'fleetobs.feed.stale{{proc="{fresh.label}"}}']["value"] == 0
        agg.scan(now=now + 1)
        dumps = os.listdir(str(tmp_path / "dumps"))
        assert len(dumps) == 1 and "fleet_feed_stale" in dumps[0]
        health = {}
        agg.dispatch_line(json.dumps({"cmd": "health"}), health.update)
        assert health["ok"] is False and health["stale"] == [dead.label]
    finally:
        flight.set_recorder(prev)
    assert rec.triggers == 1


_REQUESTS = re.compile(r'^avenir_counter_total\{group="Serve\.m",'
                       r'name="Requests"\} (\d+)', re.M)


def test_merged_scrape_over_tcp_is_the_exact_sum(tmp_path):
    """Three feeds; the port's aggregator behind its JSON-lines frontend
    answers ``metrics`` over TCP with the exact sum of the per-process
    counters, and with the counter lines of the reference aggregator's
    scrape of the same spool."""
    spool = str(tmp_path)
    now = time.time()
    values = [11, 22, 33]
    for i, v in enumerate(values):
        reg = obs.Metrics()
        reg.counters.incr("Serve.m", "Requests", v)
        reg.set_gauge("serve.queue.depth", float(i))
        _plant_feed(spool, _identity(f"w{i}", i),
                    telemetry.build_snapshot(registry=reg), now)
    agg = FleetAggregator(spool, JobConfig({}))
    agg.scan(now=now)
    fe = EventLoopFrontend(agg, "127.0.0.1", 0, io_threads=1)
    try:
        text = request_text("127.0.0.1", fe.port, {"cmd": "metrics"})
    finally:
        fe.stop()
    assert int(_REQUESTS.search(text).group(1)) == sum(values)
    ref = JaxAggregator(spool, JaxJobConfig({}))
    ref.scan(now=now)
    out = {}
    ref.dispatch_line(json.dumps({"cmd": "metrics"}), out.update)
    counters = lambda s: sorted(  # noqa: E731
        ln for ln in s.splitlines() if ln.startswith("avenir_counter"))
    assert counters(text) == counters(out["_text"])
    stats = {}
    agg.dispatch_line(json.dumps({"cmd": "stats"}), stats.update)
    assert len(stats["feeds"]) == 3


def test_reserved_spool_entries_are_not_feeds(tmp_path):
    spool = str(tmp_path)
    ident = _identity("only", 0)
    _plant_feed(spool, ident, telemetry.build_snapshot(
        registry=obs.Metrics()), time.time())
    for d in ("_incidents", os.path.join("_aggregator", FLIGHT_SUBDIR)):
        os.makedirs(os.path.join(spool, d), exist_ok=True)
    assert [os.path.basename(d) for d in feed_dirs(spool)] == [ident.label]
    shutil.rmtree(os.path.join(spool, "_incidents"))


# ---------------------------------------------------------------------------
# the reference's runbook and CI smoke through the port
# ---------------------------------------------------------------------------

def _free_ports(n: int) -> int:
    """A base port with ``base + 1 .. base + n`` free now."""
    import socket
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65000:
            continue
        try:
            socks = []
            for i in range(1, n + 1):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", base + i))
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
        return base
    raise RuntimeError("no free port range")


def test_fleetobs_smoke_through_the_port(tmp_path):
    """``resource/ci/fleetobs_smoke.py`` (CI gate 4): two publisher
    processes, ``python -m avenir_tpu_torch fleetobs`` over TCP, the fleet
    counter the exact sum."""
    from avenir_tpu_torch.runbook import REPO, run_script
    out = run_script(os.path.join(REPO, "resource", "ci",
                                  "fleetobs_smoke.py"), str(tmp_path),
                     device="cpu", timeout=300)
    assert "fleet Widgets=42 == 17+25 (exact)" in out


def test_fleetobs_runbook_through_the_port(tmp_path):
    """``resource/fleetobs/run.sh``: three ``stream --device cpu``
    services and the aggregator; the merged scrape equals the sum of the
    per-process scrapes, the stitched trace spans the processes, and a
    killed service becomes a stale gauge, a flight dump and an
    incident."""
    from avenir_tpu_torch.runbook import REPO, run_runbook
    base = _free_ports(4)
    out = run_runbook(os.path.join(REPO, "resource", "fleetobs"),
                      str(tmp_path / "fleetobs"), device="cpu",
                      env={"BASE_PORT": str(base),
                           "AGG_PORT": str(base + 4)}, timeout=300)
    assert "fleet observability runbook: ALL CLEAN" in out
    assert "(exact)" in out
    work = tmp_path / "fleetobs" / "work"
    assert "(cpu)" in open(work / "decider1.log").read()
    assert "fleetobs: aggregating" in open(work / "agg.log").read()
