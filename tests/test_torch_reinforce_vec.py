"""The port's vectorized learner fleet (``avenir_tpu_torch/models/
reinforce_vec.py``) and streaming loops (``models/streaming.py``) held
against the JAX package's on the CPU.

The three learner types step by step against the reference group under
the same seeds, every selection and every state tensor equal (masked
steps, full-fleet steps, streaming waves with duplicate rewards, enrolment
growth); the grouped streaming loop's action lines against the
reference's loop on the same queue traffic; ``FakeRedis``'s list and
stream semantics through the port's transports; and
``ReinforcementLearnerTopology`` through both command lines.
"""

import threading

import numpy as np
import pytest

from avenir_tpu.cli import main as jax_main
from avenir_tpu.models import reinforce_vec as jvec
from avenir_tpu.models import streaming as jstreaming

from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.cli import resolve
from avenir_tpu_torch.models import reinforce_vec, streaming
from avenir_tpu_torch.models.streaming import (FakeRedis, FakeRedisError,
                                               GroupedStreamingLearnerLoop,
                                               InMemoryTransport,
                                               RedisStreamTransport,
                                               RedisTransport,
                                               ReinforcementLearnerTopology,
                                               StreamingLearnerLoop)

ACTIONS = ["a", "b", "c"]
LEARNERS = {
    "upperConfidenceBoundOne": {"random.seed": "3", "min.trial": "2"},
    "upperConfidenceBoundOne-scaled": {"random.seed": "3",
                                       "reward.scale": "7"},
    "randomGreedy": {"random.seed": "5", "min.trial": "1",
                     "prob.reduction.algorithm": "logLinear"},
    "randomGreedy-linear": {"random.seed": "8",
                            "random.selection.prob": "0.3",
                            "prob.reduction.constant": "1.7",
                            "min.prob": "0.05"},
    "randomGreedy-none": {"random.seed": "9",
                          "prob.reduction.algorithm": "none"},
    "softMax": {"random.seed": "7", "temp.constant": "20",
                "temp.reduction.algorithm": "logLinear",
                "min.temp.constant": "1"},
    "softMax-linear": {"random.seed": "4", "temp.constant": "8",
                       "min.trial": "1"},
}
STATE = ("trials", "rcnt", "rsum", "total")
SOFTMAX_STATE = ("temp", "probs", "rewarded")


def _pair(case, ids):
    ltype = case.split("-")[0]
    cfg = LEARNERS[case]
    return (reinforce_vec.VectorizedLearnerGroup(ltype, ids, ACTIONS, cfg,
                                                 device="cpu"),
            jvec.VectorizedLearnerGroup(ltype, ids, ACTIONS, cfg))


def _same_state(mine, ref, where):
    names = STATE + (SOFTMAX_STATE if mine.learner_type == "softMax"
                     else ())
    for name in names:
        got = getattr(mine, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.shape == want.shape, (where, name)
        assert got.view(np.uint8).tobytes() == want.view(
            np.uint8).tobytes(), (where, name)
    assert mine.capacity == ref.capacity


@pytest.mark.parametrize("case", sorted(LEARNERS))
def test_masked_steps_match_the_reference(case):
    """30 rounds: a bulk reward scatter (duplicate group/action pairs
    included), then two masked steps over a random half of the fleet."""
    ids = [f"e{i}" for i in range(48)]
    mine, ref = _pair(case, ids)
    rng = np.random.default_rng(1)
    for rnd in range(30):
        g = list(rng.choice(ids, 40))
        a = list(rng.choice(ACTIONS, 40))
        r = [int(x) for x in rng.integers(0, 100, 40)]
        mine.set_rewards(g, a, r)
        ref.set_rewards(g, a, r)
        act = rng.random(len(ids)) < 0.5
        got, want = mine.step_masked(act, 2), ref.step_masked(act, 2)
        assert (got[:, act] == want[:, act]).all(), (case, rnd)
        _same_state(mine, ref, rnd)


@pytest.mark.parametrize("case", ["upperConfidenceBoundOne",
                                  "randomGreedy", "softMax"])
def test_full_fleet_steps_and_growth_match_the_reference(case):
    """``step`` / ``next_actions`` over the whole fleet (``batch.size``
    3), with enrolment growing the capacity in powers of two."""
    mine, ref = _pair(case, ["g0", "g1"])
    mine.batch_size = ref.batch_size = 3
    rng = np.random.default_rng(2)
    for rnd in range(12):
        if rnd % 4 == 1:
            new = [f"g{len(mine.group_ids) + i}" for i in range(5)]
            mine.add_groups(new)
            ref.add_groups(new)
        ids = mine.group_ids
        g = list(rng.choice(ids, 9))
        a = list(rng.choice(ACTIONS, 9))
        r = [int(x) for x in rng.integers(0, 50, 9)]
        mine.set_rewards(g, a, r)
        ref.set_rewards(g, a, r)
        assert mine.next_actions() == ref.next_actions()
        _same_state(mine, ref, rnd)


@pytest.mark.parametrize("case", ["upperConfidenceBoundOne",
                                  "randomGreedy", "softMax"])
def test_waved_steps_match_the_reference(case):
    """The streaming wave: one packed int32 array (rewards past ``nr``
    and rows at the capacity are padding), then ``n_steps`` masked steps;
    the key advances the same way."""
    ids = [f"e{i}" for i in range(20)]
    mine, ref = _pair(case, ids)
    rng = np.random.default_rng(3)
    for rnd in range(10):
        nr, rb, nw, wb = 11, 16, 7, 8
        packed = np.full(2 + 3 * rb + wb, mine.capacity, np.int32)
        packed[0], packed[1] = nr, nw
        packed[2:2 + 3 * rb] = 0
        packed[2:2 + nr] = rng.integers(0, len(ids), nr)
        packed[2 + rb:2 + rb + nr] = rng.integers(0, 3, nr)
        packed[2 + 2 * rb:2 + 2 * rb + nr] = rng.integers(0, 90, nr)
        packed[2 + 3 * rb:2 + 3 * rb + nw] = rng.choice(len(ids), nw,
                                                        replace=False)
        got = mine.step_waved_async(packed, rb, 2).numpy()
        want = np.asarray(ref.step_waved_async(packed, rb, 2))
        rows = packed[2 + 3 * rb:2 + 3 * rb + nw]
        assert (got[:, rows] == want[:, rows]).all(), rnd
        _same_state(mine, ref, rnd)
        assert (mine._key.numpy() == np.asarray(ref._key)).all()


def test_vectorized_group_refuses_other_learners():
    with pytest.raises(ValueError, match="unsupported"):
        reinforce_vec.VectorizedLearnerGroup("sampsonSampler", ["g"], ACTIONS,
                                             device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        reinforce_vec.VectorizedLearnerGroup(
            "softMax", ["g"], ACTIONS, {"temp.reduction.algorithm": "x"},
            device="cpu")


# ---------------------------------------------------------------------------
# the streaming loops
# ---------------------------------------------------------------------------

FLEET = {"reinforcement.learner.type": "upperConfidenceBoundOne",
         "reinforcement.learner.actions": "p1,p2,p3",
         "min.trial": "1", "reward.scale": "1"}


def _fleet_traffic(mod, waves, n_ent, wave_size, seed, config):
    """The fleet cell's queue traffic (bench.py:1593 at a small size):
    each wave's events and a reward for every other event, pushed when the
    queue drains; returns the action lines."""
    rng = np.random.default_rng(seed)
    acts = config["reinforcement.learner.actions"].split(",")

    class Refill(mod.InMemoryTransport):
        def __init__(self):
            super().__init__()
            self.wave = 0

        def next_event(self):
            if not self.events and self.wave < waves:
                w = self.wave
                self.wave += 1
                for i, e in enumerate(rng.integers(0, n_ent, wave_size)):
                    self.push_event(f"e{e}", w)
                    if i % 2 == 0:
                        self.push_reward(
                            f"e{e},{acts[int(rng.integers(3))]}",
                            int(rng.integers(0, 100)))
            return super().next_event()

    kw = {"device": "cpu"} if mod is streaming else {}
    loop = mod.GroupedStreamingLearnerLoop(
        config, mod.InMemoryTransport(),
        entities=[f"e{i}" for i in range(n_ent)], **kw)
    t = Refill()
    loop.transport = t
    assert loop.run(max_events=waves * wave_size, idle_timeout=0.0,
                    batch=wave_size) == waves * wave_size
    return t.actions, loop


@pytest.mark.parametrize("ltype", ["upperConfidenceBoundOne",
                                   "randomGreedy", "softMax"])
def test_grouped_loop_actions_equal_the_reference(ltype):
    config = dict(FLEET, **{"reinforcement.learner.type": ltype,
                            "random.seed": "21"})
    mine, loop = _fleet_traffic(streaming, 4, 64, 96, 0, config)
    theirs, jloop = _fleet_traffic(jstreaming, 4, 64, 96, 0, config)
    assert mine == theirs
    assert loop.event_count == jloop.event_count == 4 * 96
    assert loop.reward_count == jloop.reward_count


def test_grouped_loop_duplicates_enrolment_and_malformed():
    t = InMemoryTransport()
    loop = GroupedStreamingLearnerLoop(FLEET, t, device="cpu")
    for i in range(4):
        t.push_event("dup", i)
    t.push_event(",", 9)                      # empty entity: malformed
    t.rewards += ["dup,p9,3", "dup,p1,x", "dup,p2,5"]
    assert loop.step_batch() == 4
    assert len(t.actions) == 4 and loop.malformed_count == 3
    assert int(loop.group.total[loop.group.rows_for(["dup"])[0]]) == 4
    assert loop.reward_count == 1
    with pytest.raises(ValueError, match="max.pending"):
        GroupedStreamingLearnerLoop(
            dict(FLEET, **{"streaming.max.pending.batches": "0"}), t,
            device="cpu")


def test_single_learner_loop_over_the_list_protocol():
    """The reference's Redis list protocol through ``RedisTransport``
    against ``FakeRedis``: the same action lines as the reference's loop
    on the same traffic."""
    config = {"reinforcement.learner.type": "randomGreedy",
              "reinforcement.learner.actions": "a,b", "random.seed": "5"}

    def drive(mod):
        fake = mod.FakeRedis()
        loop = mod.StreamingLearnerLoop(config, mod.RedisTransport(
            "unused", 0, "events", "rewards", "actions", client=fake))
        for i in range(6):
            fake.lpush("events", f"e{i},{i}")
        fake.lpush("rewards", "a,70", "b,20")
        assert loop.run(max_events=6, idle_timeout=0.0) == 6
        return [fake.rpop("actions") for _ in range(6)], loop.reward_count

    assert drive(streaming) == drive(jstreaming)
    assert isinstance(StreamingLearnerLoop(config, InMemoryTransport())
                      .transport, InMemoryTransport)


# ---------------------------------------------------------------------------
# FakeRedis stream semantics through the port's transport
# ---------------------------------------------------------------------------

def _st(fake, name="c1", group="g"):
    return RedisStreamTransport("unused", 0, "fb", group, name, client=fake)


def test_stream_transport_round_trip_xadd_readgroup_ack():
    fake = FakeRedis()
    tr = _st(fake)
    tr.ensure_group()
    tr.ensure_group()                       # BUSYGROUP is eaten
    ids = [tr.publish({"data": f"t1,a,{i}"}) for i in range(5)]
    assert ids == ["1-0", "2-0", "3-0", "4-0", "5-0"]
    assert tr.length() == 5
    got = tr.read_new(3)
    assert [e[0] for e in got] == ids[:3] and got[0][1]["data"] == "t1,a,0"
    assert tr.pending_count() == 3
    assert tr.ack([e[0] for e in got[:2]]) == 2
    assert [e[0] for e in tr.read_pending(10)] == ["3-0"]
    assert tr.read_pending(10, after="3-0") == []
    assert [e[0] for e in tr.read_new(10)] == ids[3:]


def test_pending_redelivery_is_per_consumer_and_reads_block():
    fake = FakeRedis()
    t1, t2 = _st(fake, "c1"), _st(fake, "c2")
    t1.ensure_group()
    for i in range(4):
        t1.publish({"data": f"t1,a,{i}"})
    assert [e[0] for e in t1.read_new(2)] == ["1-0", "2-0"]
    assert [e[0] for e in t2.read_new(2)] == ["3-0", "4-0"]
    assert [e[0] for e in t1.read_pending(10)] == ["1-0", "2-0"]
    assert t2.read_new(1, block_ms=20) == []
    got = []
    th = threading.Thread(target=lambda: got.extend(
        t2.read_new(1, block_ms=2000)))
    th.start()
    t1.publish({"data": "t1,a,9"})
    th.join(timeout=5)
    assert [e[0] for e in got] == ["5-0"]
    with pytest.raises(FakeRedisError, match="NOGROUP"):
        fake.xreadgroup("nope", "c", {"fb": ">"})


def test_trim_clamps_to_slowest_consumer_group():
    fake = FakeRedis()
    tr = _st(fake)
    tr.ensure_group()
    fake.xgroup_create("fb", "lagging", id="0")
    for i in range(5):
        tr.publish({"data": f"t1,a,{i}"})
    tr.ack([e[0] for e in tr.read_new(5)])
    assert tr.trim_acked("5-0") == 0 and fake.xlen("fb") == 5
    lag = _st(fake, "c9", "lagging")
    lag.ack([lag.read_new(2)[0][0]])
    assert tr.trim_acked("5-0") == 1
    assert [e[0] for e in fake.xrange("fb")] == ["2-0", "3-0", "4-0", "5-0"]
    fake.advance_id_clock("fb", 100)
    assert tr.publish({"data": "x"}) == "101-0"


def test_list_commands_match_the_reference_double():
    mine, ref = FakeRedis(), jstreaming.FakeRedis()
    for fake in (mine, ref):
        fake.lpush("q", "a", "b", "c")
        fake.rpop("q")
    assert mine.lrange("q", 0, -1) == ref.lrange("q", 0, -1)
    assert mine.llen("q") == ref.llen("q") == 2
    assert isinstance(RedisTransport("h", 1, "e", "r", "a", client=mine)._r,
                      FakeRedis)


# ---------------------------------------------------------------------------
# ReinforcementLearnerTopology through both command lines
# ---------------------------------------------------------------------------

def test_topology_through_both_command_lines(tmp_path, capsys, monkeypatch):
    """``python -m avenir_tpu_torch ReinforcementLearnerTopology <name>
    <conf>`` beside the reference's: the job is registered under both
    names, runs the reference's queue protocol (a ``redis`` client that
    is the in-process double here) and prints the same counters; in
    process over the same events it writes the same action lines."""
    import sys
    import types

    conf = tmp_path / "topo.properties"
    conf.write_text("reinforcement.learner.type=randomGreedy\n"
                    "reinforcement.learner.actions=a,b\n"
                    "random.seed=3\n"
                    "topology.idle.timeout.sec=0.01\n"
                    "redis.server.host=unused\nredis.server.port=1\n"
                    "redis.event.queue=e\nredis.reward.queue=r\n"
                    "redis.action.queue=a\n")
    assert resolve("ReinforcementLearnerTopology")[:2] == (
        "streaming", "ReinforcementLearnerTopology")
    assert resolve("org.avenir.reinforce.ReinforcementLearnerTopology")
    lines = []
    for mod in (streaming, jstreaming):
        t = mod.InMemoryTransport()
        for i in range(5):
            t.push_event(f"e{i}", 1)
        counters = mod.ReinforcementLearnerTopology({}).run(
            "learnerTopo", str(conf), transport=t)
        assert counters.get("Topology", "EventsProcessed") == 5
        lines.append(t.actions)
    assert lines[0] == lines[1]

    stub = types.ModuleType("redis")
    stub.Redis = lambda host, port, decode_responses: FakeRedis()
    monkeypatch.setitem(sys.modules, "redis", stub)
    errs = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        assert main(["ReinforcementLearnerTopology", "learnerTopo",
                     str(conf)] + extra) == 0
        errs.append([ln for ln in capsys.readouterr().err.splitlines()
                     if "Events" in ln or "Rewards" in ln])
    assert errs[0] == errs[1] and errs[0]
