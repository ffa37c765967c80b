"""The port's stream tier (``avenir_tpu_torch/stream``: the posterior
store and its decide path, the exactly-once feedback consumer, the
decision service and its ``stream`` entry point) held against the JAX
package's ``avenir_tpu.stream`` on the CPU.

Mirrors ``tests/test_stream.py``: Thompson and UCB decisions in float32
and float64 over the same posterior and event ids equal to the
reference's; the store registry and its manifest conflict; the offset
sidecar refusing a foreign identity; the consumer exactly-once under
``feedback_dup``, ``feedback_reorder`` and ``feedback_drop`` (and a
corrupted newest checkpoint generation), its posterior equal to the batch
replay on ``[cpu]`` and ``[cpu] * 8``; the decide path over TCP beside the
reference's service; and ``resource/streaming/run.sh`` (through ``python
-m avenir_tpu_torch stream``) and ``resource/lead_gen_streaming/run.py``
through both packages from scratch copies.
"""

import json
import os
import random
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from avenir_tpu.core import faultinject as jfaultinject
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.models.streaming import FakeRedis as JaxFakeRedis
from avenir_tpu.models.streaming import \
    RedisStreamTransport as JaxTransport
from avenir_tpu.stream import posterior as jpost
from avenir_tpu.stream.consumer import FeedbackConsumer as JaxConsumer
from avenir_tpu.stream.consumer import \
    checkpointer_from_config as jax_checkpointer
from avenir_tpu.stream.service import StreamDecisionService as JaxService

from avenir_tpu_torch.core import faultinject, flight, telemetry
from avenir_tpu_torch.core.checkpoint import (CheckpointMismatch,
                                              OffsetCheckpointer)
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import read_lines
from avenir_tpu_torch.models.streaming import (FakeRedis,
                                               RedisStreamTransport)
from avenir_tpu_torch.parallel.mesh import make_mesh
from avenir_tpu_torch.runbook import REPO, run_runbook
from avenir_tpu_torch.serve.server import request
from avenir_tpu_torch.stream import posterior
from avenir_tpu_torch.stream.consumer import (FeedbackConsumer,
                                              checkpointer_from_config)
from avenir_tpu_torch.stream.posterior import (ArmPosterior,
                                               PosteriorStore, clear_stores,
                                               ensure_store, event_crc)
from avenir_tpu_torch.stream.service import StreamDecisionService

CPU = torch.device("cpu")
MESHES = {1: make_mesh([CPU]), 8: make_mesh([CPU] * 8)}
TENANTS = ["t1", "t2", "t3"]
ARMS = ["a", "b"]


def _props(tmp_path, **extra):
    props = {"stream.tenants": ",".join(TENANTS),
             "stream.arms": ",".join(ARMS),
             "stream.consumer.batch": "5",
             "stream.checkpoint.interval.events": "6",
             "checkpoint.path": str(tmp_path / "stream.ckpt")}
    props.update({k: str(v) for k, v in extra.items()})
    return props


def _events(seed, n=40):
    rng = random.Random(seed)
    return [(rng.choice(TENANTS), rng.choice(ARMS), rng.randrange(-5, 12))
            for _ in range(n)]


def _feed(transport, events):
    for t, a, r in events:
        transport.publish({"data": f"{t},{a},{r}"})


@pytest.fixture(autouse=True)
def _clean_state():
    clear_stores()
    jpost.clear_stores()
    yield
    clear_stores()
    jpost.clear_stores()
    faultinject.set_injector(None)
    jfaultinject.set_injector(None)


def _batch_replay(events, tmp_path, tag, package="port"):
    """The byte-equivalence reference: the event log replayed by the
    batch aggregator (the port's on the CPU, or the reference's)."""
    log = tmp_path / f"{tag}.csv"
    log.write_text("".join(f"{t},{a},{r}\n" for t, a, r in events))
    out = tmp_path / f"{tag}.out"
    props = {"stream.tenants": ",".join(TENANTS),
             "stream.arms": ",".join(ARMS)}
    if package == "port":
        from avenir_tpu_torch.models.bandit import BanditFeedbackAggregator
        BanditFeedbackAggregator(JobConfig(props), device="cpu").run(
            str(log), str(out))
    else:
        from avenir_tpu.models.bandit import BanditFeedbackAggregator
        BanditFeedbackAggregator(JaxConfig(props)).run(str(log), str(out))
    return list(read_lines(str(out)))


# ---------------------------------------------------------------------------
# the decide path against the reference's
# ---------------------------------------------------------------------------

def _probes(n, seed):
    rng = np.random.default_rng(seed)
    tid = rng.integers(0, len(TENANTS), n).astype(np.int32)
    crc = np.array([event_crc(f"ev{seed}-{i}") for i in range(n)], np.uint32)
    return tid, crc


@pytest.mark.parametrize("algorithm", ["thompson", "ucb"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_decisions_equal_the_reference(algorithm, dtype):
    """The same events folded into both stores, then 2,000 decisions
    over the same tenants and event ids: equal arms, equal posteriors
    (before the first fold too: UCB's untried arms)."""
    kw = dict(algorithm=algorithm, seed=41, sigma=0.75, dtype=dtype)
    mine = PosteriorStore("p", TENANTS, ARMS, device="cpu", **kw)
    ref = jpost.PosteriorStore("p", TENANTS, ARMS, **kw)
    tid, crc = _probes(2000, 3)
    assert (mine.decide(tid, crc) == ref.decide(tid, crc)).all()
    rng = np.random.default_rng(5)
    for _ in range(4):
        t = rng.integers(0, len(TENANTS), 17)
        a = rng.integers(0, len(ARMS), 17)
        r = rng.integers(-5, 40, 17)
        mine.fold_events(t, a, r)
        ref.fold_events(t, a, r)
        assert mine.host_posterior().lines() == ref.host_posterior().lines()
        assert (mine.decide(tid, crc) == ref.decide(tid, crc)).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_thompson_decide_function_on_a_wide_fleet(dtype):
    """``_thompson_decide`` and ``_ucb_decide`` themselves over 256
    tenants x 4 arms and 4,096 rows, against the reference's jitted
    functions."""
    import jax

    rng = np.random.default_rng(11)
    pulls = rng.integers(0, 60, (256, 4)).astype(np.int64)
    pulls[:8, 0] = 0
    reward = (rng.integers(-5, 12, (256, 4)) * pulls).astype(dtype)
    tid = rng.integers(0, 256, 4096).astype(np.int32)
    crc = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    for seed, sigma in ((7, 1.0), (2026, 0.37)):
        want = jax.jit(lambda p, r, i, c: jpost._thompson_decide(
            p, r, i, c, seed, sigma))(pulls, reward, tid, crc)
        got = posterior._thompson_decide(t(pulls), torch.from_numpy(reward),
                                         t(tid), t(crc), seed, sigma)
        assert (got.numpy() == np.asarray(want)).all()
    want = jax.jit(jpost._ucb_decide)(pulls, reward, tid)
    got = posterior._ucb_decide(t(pulls), torch.from_numpy(reward), t(tid))
    assert (got.numpy() == np.asarray(want)).all()


def test_decide_is_pure_function_of_event_id():
    store = PosteriorStore("p", TENANTS, ARMS, device="cpu")
    store.fold_events(np.array([0, 0, 1]), np.array([0, 1, 1]),
                      np.array([9, 1, 4]))
    tid = np.array([0, 1, 0, 0], np.int32)
    crc = np.array([11, 22, 33, 11], np.uint32)
    s1 = store.decide(tid, crc)
    assert (s1 == store.decide(tid, crc)).all()
    assert s1[0] == s1[3], "same event id must pick the same arm"
    alone = store.decide(np.array([0], np.int32), np.array([33], np.uint32))
    assert alone[0] == s1[2]


def test_arm_posterior_state_round_trip_and_merge():
    a = ArmPosterior(TENANTS, ARMS)
    a.apply(np.array([0, 0, 2]), np.array([1, 1, 0]), np.array([3, 4, 5]))
    b = ArmPosterior.from_state(a.state_dict())
    assert b.lines() == a.lines()
    b.merge(a)
    assert b.pulls[0, 1] == 4 and b.reward[0, 1] == 14.0
    assert b.lines() == jpost.ArmPosterior.from_state(
        b.state_dict()).lines()
    with pytest.raises(ValueError, match="different manifests"):
        a.merge(ArmPosterior(["x"], ARMS))


def test_restore_keeps_int64_pulls():
    """A resumed posterior with more pulls than int32 holds comes back
    whole (the store does not narrow its integer table)."""
    big = ArmPosterior(TENANTS, ARMS, pulls=np.full((3, 2), 3 * 2 ** 31),
                       reward=np.full((3, 2), 7.0))
    store = PosteriorStore("p", TENANTS, ARMS, device="cpu")
    store.restore(big.state_dict())
    store.fold_events(np.array([1]), np.array([0]), np.array([2]))
    got = store.host_posterior()
    assert got.pulls.dtype == np.int64
    assert got.pulls[1, 0] == 3 * 2 ** 31 + 1 and got.reward[1, 0] == 9.0
    with pytest.raises(ValueError, match="manifest"):
        store.restore(ArmPosterior(["x"], ARMS).state_dict())


def test_store_fold_and_decide_do_not_tear():
    """A decision reads one fold's pulls and rewards together: folds on
    one thread while another decides, every decision equal to one that
    some published state gives."""
    store = PosteriorStore("p", TENANTS, ARMS, algorithm="ucb",
                           device="cpu")
    states, decisions, stop = [], [], threading.Event()
    tid, crc = _probes(64, 9)

    def decide():
        while not stop.is_set():
            decisions.append(store.decide(tid, crc))

    th = threading.Thread(target=decide)
    th.start()
    rng = np.random.default_rng(2)
    try:
        for _ in range(60):
            store.fold_events(rng.integers(0, 3, 8), rng.integers(0, 2, 8),
                              rng.integers(0, 9, 8))
            states.append(store.host_posterior().state_dict())
    finally:
        stop.set()
        th.join()
    allowed = {tuple(np.zeros(64, np.int64))}
    for st in states:
        s = PosteriorStore("q", TENANTS, ARMS, algorithm="ucb", device="cpu")
        s.restore(st)
        allowed.add(tuple(s.decide(tid, crc)))
    assert decisions and all(tuple(d) in allowed for d in decisions)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_ensure_store_rejects_conflicting_manifest(tmp_path):
    cfg = JobConfig(_props(tmp_path))
    store = ensure_store(cfg, device="cpu")
    assert ensure_store(JobConfig({"stream.store": "default"})) is store
    assert ensure_store(JobConfig(dict(_props(tmp_path)))) is store
    assert posterior.get_store("default") is store
    for key, bad in (("stream.arms", "a,b,EXTRA"),
                     ("stream.algorithm", "ucb"), ("stream.seed", "5"),
                     ("stream.posterior.dtype", "float32")):
        with pytest.raises(ValueError, match="already registered"):
            ensure_store(JobConfig(dict(_props(tmp_path), **{key: bad})))
    other = PosteriorStore("other", TENANTS, ARMS, device="cpu")
    assert posterior.register_store(other) is posterior.get_store("other")
    clear_stores()
    assert posterior.get_store("default") is None


def test_offset_checkpointer_rejects_foreign_identity(tmp_path):
    path = str(tmp_path / "o.ckpt")
    ck = OffsetCheckpointer(path, 4, {"stream": "fb", "group": "g"})
    ck.save("3-0", {"pulls": np.zeros(2, np.int64)}, {"x": 1})
    other = OffsetCheckpointer(path, 4, {"stream": "OTHER", "group": "g"},
                               resume=True)
    with pytest.raises(CheckpointMismatch, match="identity"):
        other.load()
    same = OffsetCheckpointer(path, 4, {"stream": "fb", "group": "g"},
                              resume=True)
    payload = same.load()
    assert payload["offset"] == "3-0" and payload["state"] == {"x": 1}
    with pytest.raises(ValueError, match="interval"):
        OffsetCheckpointer(path, 0, {})


# ---------------------------------------------------------------------------
# the consumer: exactly-once, against the batch replay and the reference
# ---------------------------------------------------------------------------

def _transport(fake, name="c1"):
    return RedisStreamTransport("unused", 0, "fb", "g", name, client=fake)


def _stream_consume(events, tmp_path, mesh=None, fault_plan=None, tag="s",
                    batch=5):
    """Feed the events into a fresh stream and consume them under an
    optional fault plan; a ``feedback_drop`` crash is followed by a
    fresh consumer of the same name with ``--resume`` (an operator
    restart).  Returns (store, consumer)."""
    fake = FakeRedis()
    tr = _transport(fake)
    tr.ensure_group()
    _feed(tr, events)
    props = _props(tmp_path, **{"checkpoint.path":
                                str(tmp_path / f"{tag}.ckpt"),
                                "stream.consumer.batch": batch})
    cfg = JobConfig(dict(props, **({"fault.inject.plan": fault_plan}
                                   if fault_plan else {})))
    faultinject.configure_from_config(cfg)
    dev = None if mesh is not None else "cpu"
    store = PosteriorStore.from_config(f"{tag}-1", cfg, device=dev,
                                       mesh=mesh)
    cons = FeedbackConsumer(cfg, store, tr, checkpointer=(
        checkpointer_from_config(cfg, store, props["checkpoint.path"])))
    crashed = False
    try:
        cons.run(idle_timeout=0.05)
    except faultinject.InjectedFault:
        crashed = True
    faultinject.set_injector(None)
    if not crashed:
        return store, cons
    cfg2 = JobConfig(dict(props, **{"checkpoint.resume": "true"}))
    store2 = PosteriorStore.from_config(f"{tag}-2", cfg2, device=dev,
                                        mesh=mesh)
    cons2 = FeedbackConsumer(cfg2, store2, _transport(fake),
                             checkpointer=checkpointer_from_config(
                                 cfg2, store2, props["checkpoint.path"]))
    cons2.run(idle_timeout=0.05)
    return store2, cons2


def _jax_consume(events, tmp_path, fault_plan, tag):
    """The reference consumer under the same plan (its own helper's
    shape, tests/test_stream.py::_stream_consume)."""
    fake = JaxFakeRedis()
    tr = JaxTransport("unused", 0, "fb", "g", "c1", client=fake)
    tr.ensure_group()
    for t, a, r in events:
        tr.publish({"data": f"{t},{a},{r}"})
    props = _props(tmp_path, **{"checkpoint.path":
                                str(tmp_path / f"{tag}.ckpt")})
    cfg = JaxConfig(dict(props, **{"fault.inject.plan": fault_plan}))
    jfaultinject.configure_from_config(cfg)
    store = jpost.PosteriorStore.from_config(f"{tag}-1", cfg)
    cons = JaxConsumer(cfg, store, tr, checkpointer=jax_checkpointer(
        cfg, store, props["checkpoint.path"]))
    try:
        cons.run(idle_timeout=0.05)
        return store, cons
    except jfaultinject.InjectedFault:
        pass
    finally:
        jfaultinject.set_injector(None)
    cfg2 = JaxConfig(dict(props, **{"checkpoint.resume": "true"}))
    store2 = jpost.PosteriorStore.from_config(f"{tag}-2", cfg2)
    cons2 = JaxConsumer(cfg2, store2, JaxTransport(
        "unused", 0, "fb", "g", "c1", client=fake),
        checkpointer=jax_checkpointer(cfg2, store2,
                                      props["checkpoint.path"]))
    cons2.run(idle_timeout=0.05)
    return store2, cons2


@pytest.mark.parametrize("mesh", [1, 8])
@pytest.mark.parametrize("seed", [11, 23, 47])
def test_equivalence_gate(tmp_path, mesh, seed):
    """An event log consumed through the stream, with one duplicate
    delivery and one crash and resume, gives the batch replay's posterior
    byte for byte, on [cpu] and on [cpu] * 8."""
    events = _events(seed)
    store, cons = _stream_consume(
        events, tmp_path, MESHES[mesh],
        fault_plan="feedback_dup@1,feedback_drop@4", tag=f"g{seed}")
    lines = store.host_posterior().lines()
    assert lines == _batch_replay(events, tmp_path, f"b{seed}")
    assert lines == _batch_replay(events, tmp_path, f"j{seed}", "jax")
    assert cons.counters.get("Stream", "Events applied") == len(events)


@pytest.mark.parametrize("plan", ["feedback_dup@2", "feedback_reorder@3",
                                  "feedback_drop@4",
                                  "feedback_dup@2,feedback_reorder@3,"
                                  "feedback_drop@4"])
def test_fault_points_fire_as_the_reference_consumer(tmp_path, plan):
    """Each feedback fault point under the same plan in both consumers:
    the same posterior (the batch replay's), the same exactly-once
    counters, the same offset."""
    events = _events(31, n=50)
    store, cons = _stream_consume(events, tmp_path, fault_plan=plan,
                                  tag="p")
    jstore, jcons = _jax_consume(events, tmp_path, plan, "j")
    lines = store.host_posterior().lines()
    assert lines == jstore.host_posterior().lines()
    assert lines == _batch_replay(events, tmp_path, "b")
    assert cons.stats() == jcons.stats()
    assert cons.counters.get("Stream", "Events applied") == len(events)
    if "dup" in plan:
        assert cons.counters.get("Stream", "Duplicates skipped") > 0


@pytest.mark.parametrize("seed", [5, 17, 29])
def test_exactly_once_chaos_generation_fallback(tmp_path, seed):
    """Killed mid-stream with the newest checkpoint generation corrupted:
    resume falls back a generation and the posterior and decisions equal
    the uninterrupted run's, every event applied once."""
    events = _events(seed, n=50)
    clean, clean_cons = _stream_consume(events, tmp_path,
                                        tag=f"clean{seed}")

    def decide_all(store):
        probes = [(f"ev{k}", t) for t in TENANTS for k in range(3)]
        tid = np.array([store.tenant_index[t] for _, t in probes], np.int32)
        crc = np.array([event_crc(e) for e, _ in probes], np.uint32)
        return [f"{e},{t},{store.arms[int(s)]}"
                for (e, t), s in zip(probes, store.decide(tid, crc))]

    def fallbacks():
        return telemetry.get_metrics().counters.get(
            "Durability", "Generation fallbacks")

    before = fallbacks()
    chaos, cons = _stream_consume(
        events, tmp_path,
        fault_plan="feedback_dup@1,feedback_drop@6,ckpt_corrupt@2x99",
        tag=f"chaos{seed}")
    assert chaos.host_posterior().lines() == clean.host_posterior().lines()
    assert decide_all(chaos) == decide_all(clean)
    assert cons.counters.get("Stream", "Events applied") == len(events)
    assert int(chaos.host_posterior().pulls.sum()) == len(events)
    assert cons.counters.get("Stream", "Duplicates skipped") > 0
    assert fallbacks() > before
    assert clean_cons.counters.get("Stream", "Events applied") \
        == len(events)


def test_trimmed_stream_resumes_byte_identical(tmp_path):
    events = _events(13, n=60)
    store, cons = _stream_consume(events, tmp_path, tag="t", batch=7)
    fake = FakeRedis()
    tr = _transport(fake)
    tr.ensure_group()
    _feed(tr, events)
    props = _props(tmp_path, **{"checkpoint.path": str(tmp_path / "tt.ckpt"),
                                "stream.trim.enable": "true"})
    cfg = JobConfig(props)
    st = PosteriorStore.from_config("tt", cfg, device="cpu")
    c = FeedbackConsumer(cfg, st, tr, checkpointer=checkpointer_from_config(
        cfg, st, props["checkpoint.path"]))
    c.run(idle_timeout=0.05)
    assert c.counters.get("Stream", "Trimmed entries") > 0
    assert st.host_posterior().lines() == store.host_posterior().lines()


def test_decision_reward_share_trace_and_one_regret_dump(tmp_path):
    """A decide response's trace id rides the reward event; crossing the
    regret threshold writes exactly one flight dump naming that trace."""
    from avenir_tpu_torch.core import obs

    dump_dir = str(tmp_path / "flight")
    obs.configure(enabled=True, sample_rate=1.0)
    try:
        cfg = JobConfig(_props(tmp_path, **{
            "stream.regret.threshold": "5", "stream.tenants": "t1",
            "flight.dump.dir": dump_dir,
            "flight.dump.min.interval.sec": "0", "serve.port": "0"}))
        service = StreamDecisionService(cfg, device="cpu")
        try:
            resp = service.server.handle_line(json.dumps(
                {"model": "decisions", "decide": "ev1,t1",
                 "trace_id": "cafe1234cafe1234"}))
            assert resp["trace_id"] == "cafe1234cafe1234", resp
            _, _, arm = resp["output"].split(",")
            other = [a for a in ARMS if a != arm][0]
            assert service.server.handle_line(json.dumps(
                {"cmd": "feedback", "event": f"t1,{other},10"}))["ok"]
            for _ in range(12):
                service.server.handle_line(json.dumps(
                    {"cmd": "feedback", "event": f"t1,{arm},0",
                     "trace": resp["trace_id"]}))
            service.consumer.run(idle_timeout=0.05)
            dumps = [d for d in sorted(os.listdir(dump_dir))
                     if d.startswith("flight-regret-anomaly")]
            assert len(dumps) == 1 and "cafe1234cafe1234" in dumps[0]
            assert service.consumer.counters.get(
                "Stream", "Regret anomalies") == 1
        finally:
            service.stop()
    finally:
        obs.configure(enabled=False, sample_rate=1.0)
        obs.get_tracer().clear()
        flight.set_recorder(flight.FlightRecorder())


# ---------------------------------------------------------------------------
# the decision service over TCP, beside the reference's
# ---------------------------------------------------------------------------

def _wait_applied(counters_of, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if counters_of().get("Events applied", 0) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"consumer did not apply {n} events")


@pytest.mark.parametrize("algorithm", ["thompson", "ucb"])
def test_decide_over_tcp_equals_the_reference_service(tmp_path, algorithm):
    """Both services on ephemeral ports, the same decides before and after
    the same feedback: byte-equal responses, and the port's ``stream``
    audit equal to the reference's and to the batch replay."""
    events = _events(3, n=20)
    extra = {"serve.port": "0", "stream.algorithm": algorithm,
             "stream.seed": "41"}
    mine = StreamDecisionService(JobConfig(_props(
        tmp_path / "p", **extra)), device="cpu")
    ref = JaxService(JaxConfig(_props(tmp_path / "j", **extra)))
    try:
        ports = mine.start(), ref.start()
        asks = [{"model": "decisions", "decide": f"e{i},{TENANTS[i % 3]}"}
                for i in range(12)]
        asks += [{"model": "decisions", "row": "e1,t1"},
                 {"model": "decisions", "decide": "e9,nope"},
                 {"model": "decisions", "rows": ["e3,t2", "e4,t3", "x"]}]

        def answers(port):
            out = []
            for obj in asks:
                r = request("127.0.0.1", port, obj)
                r.pop("trace_id", None)
                out.append(r)
            return out

        assert answers(ports[0]) == answers(ports[1])
        for port in ports:
            for t, a, r in events:
                assert request("127.0.0.1", port, {
                    "cmd": "feedback", "event": f"{t},{a},{r}"})["ok"]
        _wait_applied(lambda: mine.consumer.counters.as_dict().get(
            "Stream", {}), len(events))
        _wait_applied(lambda: ref.consumer.counters.as_dict().get(
            "Stream", {}), len(events))
        after = answers(ports[0])
        assert after == answers(ports[1])
        assert "error" in after[13] and "output" in after[0]
        audit = request("127.0.0.1", ports[0], {"cmd": "stream"})
        assert audit["posterior"] == request(
            "127.0.0.1", ports[1], {"cmd": "stream"})["posterior"]
        assert audit["posterior"] == _batch_replay(events, tmp_path, "tcp")
        assert audit["consumer"]["counters"]["Events applied"] \
            == len(events)
    finally:
        mine.stop()
        ref.stop()


def test_replica_pool_shares_one_posterior(tmp_path):
    cfg = JobConfig(_props(tmp_path, **{"serve.port": "0",
                                        "serve.pool.replicas": "2"}))
    service = StreamDecisionService(cfg, device="cpu")
    try:
        replicas = service.server.pool.variant_groups(
            service.model_name)[0].replicas
        a0, a1 = (r.entry.adapter for r in replicas)
        assert a0.store is a1.store is service.store
        service.store.fold_events(np.array([1]), np.array([0]),
                                  np.array([7]))
        out0 = a0.predict_lines(["e5,t2"])
        assert out0 == a1.predict_lines(["e5,t2"]) and out0[0] is not None
    finally:
        service.stop()


# ---------------------------------------------------------------------------
# the runbooks through both packages
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _work_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            # a server's log, and the consumer's sidecars (their counters
            # depend on how the entries happened to batch)
            if f.endswith(".log") or ".ckpt" in f:
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_streaming_runbook_through_the_port(tmp_path):
    """``resource/streaming/run.sh`` with ``python -m avenir_tpu_torch
    stream --device cpu``: 120 TCP decisions, a SIGTERM, ``--resume``, 80
    more, and its own audit (the live posterior ``cmp``'d against the
    batch replay) pass; every work file (the event log with the chosen
    arms, the live posterior, the replay) equals the reference's run."""
    src = os.path.join(REPO, "resource", "streaming")
    legs = (("port", True, "cpu"), ("ref", False, None))

    def leg(name, port, dev):
        out = run_runbook(src, str(tmp_path / name), device=dev, port=port,
                          env={"PORT": str(_free_port())}, timeout=300)
        return out, _work_files(str(tmp_path / name / "work"))

    with ThreadPoolExecutor(2) as pool:
        (mine, mfiles), (theirs, tfiles) = pool.map(lambda a: leg(*a), legs)
    assert "byte-identical" in mine
    assert mfiles == tfiles
    assert len(mfiles["events.csv"].splitlines()) == 200
    log = open(tmp_path / "port" / "work" / "serve2.log").read()
    assert "streaming decisions for model 'decisions'" in log
    assert "(cpu)" in log


def test_lead_gen_streaming_runbook_through_the_port(tmp_path):
    """``resource/lead_gen_streaming/run.py``: the UCB1 loop fed by the
    port's ``ctr_reward_sampler`` converges on page3 with the reference's
    selections."""
    src = os.path.join(REPO, "resource", "lead_gen_streaming")
    mine = run_runbook(src, str(tmp_path / "port"), device="cpu")
    theirs = run_runbook(src, str(tmp_path / "ref"), port=False)
    assert "page3 (best hidden CTR) dominates: OK" in mine
    assert mine == theirs
