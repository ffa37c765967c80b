"""The port's batch bandits (``avenir_tpu_torch/models/bandit.py`` on
``models/reinforce.py`` and ``core/stats.py``) and its feedback
aggregator (``stream/posterior.py``'s fold) held against the JAX
package's on the CPU.

Mirrors the batch-bandit and learner cases of ``tests/test_reinforce.py``:
every learner type from the factory, the UCB1 oracle, convergence on a
planted bandit (the port's selections equal the reference's under the same
seeds), the four batch bandit jobs and the exploration counter, each
through both packages with byte-equal outputs; ``aggregate_rewards`` and
``RunningAggregator``'s use of it; ``BanditFeedbackAggregator`` on
``[cpu]`` and ``[cpu] * 8`` against the reference's; the
``gen_price_rounds`` fixture; and ``resource/bandit_variants/run.py`` and
``resource/price_optimize/run.py`` through both packages from scratch
copies.  The vectorized learners and the streaming loop wait for the
stream tier.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from avenir_tpu.core import JobConfig as JaxConfig
from avenir_tpu.core import write_output as jax_write_output
from avenir_tpu.datagen import gen_price_rounds as jax_gen_price_rounds
from avenir_tpu.models import bandit as jbandit
from avenir_tpu.models import reinforce as jreinforce

from avenir_tpu_torch import datagen
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.stats import HistogramStat
from avenir_tpu_torch.models import bandit, reinforce
from avenir_tpu_torch.models.bandit import (ExplorationCounter,
                                            aggregate_rewards)
from avenir_tpu_torch.parallel.mesh import make_mesh
from avenir_tpu_torch.runbook import (REPO, price_optimize_edit,
                                      run_runbook)

CPU = torch.device("cpu")
MESHES = {1: make_mesh([CPU]), 8: make_mesh([CPU] * 8)}
ACTIONS = ["a", "b", "c"]

LEARNER_CONFIGS = {
    "intervalEstimator": {"bin.width": "10", "confidence.limit": "90",
                          "min.confidence.limit": "50",
                          "confidence.limit.reduction.step": "5",
                          "confidence.limit.reduction.round.interval": "10",
                          "min.reward.distr.sample": "5"},
    "sampsonSampler": {"min.sample.size": "5", "max.reward": "100"},
    "optimisticSampsonSampler": {"min.sample.size": "5", "max.reward": "100"},
    "randomGreedy": {},
    "upperConfidenceBoundOne": {},
    "upperConfidenceBoundTwo": {},
    "softMax": {"temp.constant": "20", "temp.reduction.algorithm": "logLinear",
                "min.temp.constant": "1"},
    "actionPursuit": {"pursuit.learning.rate": "0.05"},
    "rewardComparison": {"intial.reference.reward": "50"},
    "exponentialWeight": {"distr.constant": "0.2", "reward.scale": "100"},
}


def _planted_reward(rng, action_id):
    """Arm 'b' is best: mean 80 against 40 and 20."""
    means = {"a": 40, "b": 80, "c": 20}
    return int(np.clip(rng.normal(means[action_id], 10), 0, 100))


def test_factory_creates_all_reference_learner_types():
    for name, extra in LEARNER_CONFIGS.items():
        cfg = dict(extra, **{"random.seed": "42"})
        learner = reinforce.create_learner(name, ACTIONS, cfg)
        assert learner.find_action("a") is not None
        assert (type(reinforce.ReinforcementLearnerFactory.create(
            name, ACTIONS, cfg)) is type(learner))
        assert (type(learner).__name__
                == type(jreinforce.create_learner(name, ACTIONS,
                                                  cfg)).__name__)
    with pytest.raises(ValueError):
        reinforce.create_learner("noSuchLearner", ACTIONS, {})


def test_ucb1_score_oracle():
    learner = reinforce.create_learner(
        "upperConfidenceBoundOne", ["x", "y"],
        {"reward.scale": "1", "random.seed": "0"})
    for r in (9, 10, 11):
        learner.find_action("x").select()
        learner.set_reward("x", r)
    learner.find_action("y").select()
    learner.set_reward("y", 5)
    learner.total_trial_count = 5
    x, y = learner.find_action("x"), learner.find_action("y")
    assert learner._ucb_score(x) == pytest.approx(
        10 + math.sqrt(2 * math.log(5) / 3))
    assert learner._ucb_score(y) == pytest.approx(
        5 + math.sqrt(2 * math.log(5) / 1))
    learner.total_trial_count = 4
    assert learner.next_action().id == "x"


def test_ucb1_untried_arm_first():
    learner = reinforce.create_learner("upperConfidenceBoundOne", ACTIONS,
                                       {"random.seed": "0"})
    assert {learner.next_action().id for _ in range(3)} == set(ACTIONS)


def _drive(mod, name):
    """600 rounds of learning, then 200 picks, on a planted bandit."""
    cfg = dict(LEARNER_CONFIGS[name], **{"random.seed": "123",
                                         "min.trial": "10"})
    learner = mod.create_learner(name, ACTIONS, cfg)
    rng = np.random.default_rng(7)
    picks = []
    for _ in range(800):
        action = learner.next_action()
        picks.append(action.id)
        learner.set_reward(action.id, _planted_reward(rng, action.id))
    return picks


@pytest.mark.parametrize("name", sorted(LEARNER_CONFIGS))
def test_learner_converges_as_the_reference(name):
    """Every learner concentrates on the planted best arm 'b', with the
    reference's selections pick for pick."""
    picks = _drive(reinforce, name)
    assert picks == _drive(jreinforce, name)
    late = picks[600:]
    assert late.count("b") == max(late.count(a) for a in ACTIONS), name


def test_min_trial_bootstrap():
    learner = reinforce.create_learner("upperConfidenceBoundOne", ACTIONS,
                                       {"min.trial": "5", "random.seed": "1"})
    for _ in range(15):
        a = learner.next_action()
        learner.set_reward(a.id, 100 if a.id == "a" else 0)
    assert all(learner.find_action(x).trial_count >= 5 for x in ACTIONS)


def test_histogram_confidence_bounds():
    h = HistogramStat(10)
    for v in [5, 15, 15, 25, 25, 25, 35, 35, 45, 95]:
        h.add(v)
    assert h.get_confidence_bounds(100) == (0, 100)
    lo, hi = h.get_confidence_bounds(60)
    assert lo >= 10 and hi <= 50


def test_softmax_decay_divisor_matches_reference():
    learner = reinforce.create_learner(
        "softMax", ACTIONS,
        {"temp.constant": "8", "temp.reduction.algorithm": "linear",
         "random.seed": "5"})
    learner.rewarded = True
    for a in ACTIONS:
        learner.reward_stats[a].add(10)
    learner.next_action()
    assert learner.temp_constant == pytest.approx(8.0 / 2.0)


def test_reinforcement_learner_group_per_entity_state():
    group = reinforce.ReinforcementLearnerGroup(
        {"learner.type": "upperConfidenceBoundOne", "action.list": "a,b,c",
         "random.seed": "9"})
    group.add_learner("user1")
    group.add_learner("user2")
    assert group.get_learner("user1") is not group.get_learner("user2")
    assert group.get_learner("nope") is None
    for _ in range(30):
        act = group.next_actions("user1")[0]
        group.set_reward("user1", act.id, 90 if act.id == "b" else 5)
    u1, u2 = group.get_learner("user1"), group.get_learner("user2")
    assert sum(a.trial_count for a in u1.actions) == 30
    assert sum(a.trial_count for a in u2.actions) == 0
    assert u1.find_best_action().id == "b"
    with pytest.raises(ValueError, match="unknown learner id"):
        group.next_actions("ghost")
    assert (reinforce.ReinforcementLearnerGroup(
        {"action.list": "x,y"}).learner_type == "randomGreedy")


# ---------------------------------------------------------------------------
# batch bandit jobs
# ---------------------------------------------------------------------------

def _bandit_rows(counts, rewards):
    return [f"{g},{item},{cnt},{rewards[g][item]}"
            for g, items in counts.items() for item, cnt in items.items()]


def _props(tmp_path, **extra):
    props = {"count.ordinal": "2", "reward.ordinal": "3",
             "group.item.count.path": str(tmp_path / "batch.txt"),
             "random.seed": "9"}
    props.update({k.replace("_", "."): str(v) for k, v in extra.items()})
    return props


def _read(path) -> bytes:
    with open(os.path.join(str(path), "part-r-00000"), "rb") as fh:
        return fh.read()


def _both(tmp_path, cls_name, props, out="out"):
    """One bandit job through both packages; the port's lines."""
    getattr(bandit, cls_name)(JobConfig(dict(props)), device="cpu").run(
        str(tmp_path / "in"), str(tmp_path / out))
    getattr(jbandit, cls_name)(JaxConfig(dict(props))).run(
        str(tmp_path / "in"), str(tmp_path / ("j" + out)))
    got = _read(tmp_path / out)
    assert got == _read(tmp_path / ("j" + out))
    return got.decode().splitlines()


def test_greedy_random_bandit_late_round_exploits(tmp_path):
    jax_write_output(str(tmp_path / "in"), _bandit_rows(
        {"g1": {"p1": 20, "p2": 20, "p3": 20}},
        {"g1": {"p1": 10, "p2": 90, "p3": 30}}))
    (tmp_path / "batch.txt").write_text("g1,1\n")
    assert _both(tmp_path, "GreedyRandomBandit",
                 _props(tmp_path, current_round_num=50)) == ["g1,p2"]


def test_greedy_random_bandit_auer_untried_first(tmp_path):
    jax_write_output(str(tmp_path / "in"), _bandit_rows(
        {"g1": {"p1": 5, "p2": 0, "p3": 5}},
        {"g1": {"p1": 50, "p2": 0, "p3": 60}}))
    (tmp_path / "batch.txt").write_text("g1,2\n")
    lines = _both(tmp_path, "GreedyRandomBandit", _props(
        tmp_path, current_round_num=3,
        **{"prob.reduction.algorithm": "AuerGreedy"}))
    assert "g1,p2" in lines and len(lines) == 2


@pytest.mark.parametrize("algo", ["linear", "logLinear", "AuerGreedy"])
@pytest.mark.parametrize("rnd", [1, 4, 30])
def test_greedy_random_bandit_many_groups(tmp_path, algo, rnd):
    """Twelve groups of eight items, random counts and rewards: every
    decay schedule selects the reference's items."""
    rng = np.random.default_rng(rnd)
    counts = {f"g{g}": {f"p{i}": int(rng.integers(0, 4)) for i in range(8)}
              for g in range(12)}
    rewards = {g: {i: int(rng.integers(0, 100)) for i in items}
               for g, items in counts.items()}
    jax_write_output(str(tmp_path / "in"), _bandit_rows(counts, rewards))
    (tmp_path / "batch.txt").write_text(
        "".join(f"g{g},{1 + g % 3}\n" for g in range(12)))
    lines = _both(tmp_path, "GreedyRandomBandit", _props(
        tmp_path, current_round_num=rnd, random_seed=rnd,
        **{"prob.reduction.algorithm": algo}))
    assert lines


def test_auer_deterministic_ucb(tmp_path):
    jax_write_output(str(tmp_path / "in"), _bandit_rows(
        {"g1": {"p1": 100, "p2": 100, "p3": 1}},
        {"g1": {"p1": 50, "p2": 55, "p3": 40}}))
    (tmp_path / "batch.txt").write_text("g1,2\n")
    lines = _both(tmp_path, "AuerDeterministic",
                  _props(tmp_path, current_round_num=20))
    assert set(lines) == {"g1,p2", "g1,p3"}


def test_softmax_bandit_prefers_high_reward(tmp_path):
    jax_write_output(str(tmp_path / "in"), _bandit_rows(
        {"g1": {f"p{i}": 10 for i in range(1, 6)}},
        {"g1": {"p1": 5, "p2": 5, "p3": 100, "p4": 5, "p5": 5}}))
    (tmp_path / "batch.txt").write_text("g1,1\n")
    wins = 0
    for seed in range(20):
        lines = _both(tmp_path, "SoftMaxBandit", _props(
            tmp_path, current_round_num=2, random_seed=seed,
            **{"temp.constant": "0.1"}), out=f"out{seed}")
        wins += lines == ["g1,p3"]
    assert wins >= 18


def test_random_first_greedy_phases(tmp_path):
    jax_write_output(str(tmp_path / "in"), [
        f"g1,p{i},{r}" for i, r in zip(range(1, 5), [10, 90, 30, 50])])
    (tmp_path / "batch.txt").write_text("g1,4,2\n")
    assert len(_both(tmp_path, "RandomFirstGreedyBandit",
                     _props(tmp_path, current_round_num=2),
                     out="o1")) == 2
    assert _both(tmp_path, "RandomFirstGreedyBandit",
                 _props(tmp_path, current_round_num=10),
                 out="o2") == ["g1,p2", "g1,p4"]


def test_exploration_counter_ranges():
    ec = ExplorationCounter("g", count=5, exploration_count=12, batch_size=2)
    ec.select_next_round(1)
    assert ec.is_in_exploration()
    assert ec.should_explore(2) and ec.should_explore(3)
    assert not ec.should_explore(0) and not ec.should_explore(4)
    ec.select_next_round(7)
    assert not ec.is_in_exploration()
    ec.select_next_round(5)
    assert ec.should_explore(4) and ec.should_explore(0)
    assert not ec.should_explore(2)


def test_bandit_missing_group_in_side_file_raises(tmp_path):
    jax_write_output(str(tmp_path / "batch.txt"), ["g0,3"])
    jax_write_output(str(tmp_path / "in"), ["gX,item1,0,0", "gX,item2,0,0"])
    for job in (bandit.GreedyRandomBandit(JobConfig(_props(tmp_path)),
                                          device="cpu"),
                jbandit.GreedyRandomBandit(JaxConfig(_props(tmp_path)))):
        with pytest.raises(ValueError, match="gX"):
            job.run(str(tmp_path / "in"), str(tmp_path / "out"))


def test_aggregate_rewards_running_average():
    prev, scored = ["g1,p1,2,50"], ["g1,p1,80", "g1,p2,60"]
    out = aggregate_rewards(scored, prev)
    assert out == jbandit.aggregate_rewards(scored, prev)
    state = {tuple(l.split(",")[:2]): l.split(",")[2:] for l in out}
    assert state[("g1", "p1")] == ["3", "60"]
    assert state[("g1", "p2")] == ["1", "60"]


def test_running_aggregator_uses_the_bandit_module_s_aggregate():
    from avenir_tpu_torch.models import chombo

    assert chombo.aggregate_rewards is bandit.aggregate_rewards


def test_price_rounds_fixture_is_the_reference_s():
    got = datagen.gen_price_rounds(15, 4, seed=43)
    want = jax_gen_price_rounds(15, 4, seed=43)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2](3, 1, np.random.default_rng(5))
            == want[2](3, 1, np.random.default_rng(5)))


# ---------------------------------------------------------------------------
# the feedback aggregator (the posterior fold)
# ---------------------------------------------------------------------------

TENANTS, ARMS = ["t1", "t2", "t3"], ["a", "b", "c", "d"]


def _event_log(path, n=5000, seed=4, junk=True):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        t = TENANTS[int(rng.integers(3))]
        a = ARMS[int(rng.integers(4))]
        lines.append(f"{t},{a},{int(rng.integers(-50, 1000))}")
        if junk and i % 97 == 0:        # malformed events, skipped
            lines.append(["tX,a,5", "t1,zz,5", "t1,a,1_0", "t1,a",
                          "t2,b,3.5"][i % 5])
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("n_pos", [1, 8])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("chunk", [None, "333"])
def test_feedback_aggregator_matches_reference(tmp_path, mesh8, n_pos,
                                               dtype, chunk):
    log = _event_log(tmp_path / "events.csv")
    props = {"stream.tenants": ",".join(TENANTS),
             "stream.arms": ",".join(ARMS), "stream.posterior.dtype": dtype}
    if chunk:
        props["pipeline.chunk.rows"] = chunk
    counters = bandit.BanditFeedbackAggregator(
        JobConfig(dict(props)), device="cpu").run(
            log, str(tmp_path / "out"), mesh=MESHES[n_pos])
    jbandit.BanditFeedbackAggregator(JaxConfig(dict(props))).run(
        log, str(tmp_path / "jout"), mesh=mesh8)
    got = _read(tmp_path / "out")
    assert got == _read(tmp_path / "jout")
    assert len(got.decode().splitlines()) == len(TENANTS) * len(ARMS)
    assert counters.get("Stream", "Malformed events") == 52
    assert counters.get("Stream", "Events folded") == 5000


def test_feedback_aggregator_without_mesh_and_column_mapping(tmp_path,
                                                             mesh1):
    """The job's own device when no mesh is given; columns remapped."""
    rng = np.random.default_rng(8)
    (tmp_path / "log.csv").write_text("".join(
        f"{i},{int(rng.integers(0, 9))},{TENANTS[i % 3]},"
        f"{ARMS[int(rng.integers(4))]}\n" for i in range(700)))
    props = {"stream.tenants": ",".join(TENANTS),
             "stream.arms": ",".join(ARMS), "stream.tenant.ordinal": "2",
             "stream.arm.ordinal": "3", "stream.reward.ordinal": "1"}
    bandit.BanditFeedbackAggregator(JobConfig(dict(props)),
                                    device="cpu").run(
        str(tmp_path / "log.csv"), str(tmp_path / "out"))
    jbandit.BanditFeedbackAggregator(JaxConfig(dict(props))).run(
        str(tmp_path / "log.csv"), str(tmp_path / "jout"), mesh=mesh1)
    assert _read(tmp_path / "out") == _read(tmp_path / "jout")


def test_feedback_manifest_errors_are_the_reference_s(tmp_path):
    from avenir_tpu.stream import posterior as jpost
    from avenir_tpu_torch.stream import posterior

    for props in ({"stream.arms": "a,b"},
                  {"stream.tenants": "t,t", "stream.arms": "a,b"},
                  {"stream.tenants": "t", "stream.arms": "a"},
                  {"stream.tenants": "t", "stream.arms": "a,a"},
                  {"stream.tenants": "t", "stream.arms": "a,b",
                   "stream.posterior.dtype": "float16"}):
        msgs = []
        for mod, cfg in ((posterior, JobConfig), (jpost, JaxConfig)):
            with pytest.raises((KeyError, ValueError)) as ei:
                mod.FeedbackFoldSpec(cfg(dict(props)), str(tmp_path / "o"))
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the runbooks
# ---------------------------------------------------------------------------

ENV = {"JAX_PLATFORMS": "cpu", "AVENIR_PLATFORM": "cpu"}


@pytest.fixture(scope="module")
def bandit_runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_bandit_runbooks")
    logs = {}
    for name, edit in (("bandit_variants", None),
                       ("price_optimize", price_optimize_edit)):
        src = os.path.join(REPO, "resource", name)
        logs[("jax", name)] = run_runbook(
            src, str(tmp / "jax" / name), port=False, env=ENV, edit=edit)
        logs[("port", name)] = run_runbook(
            src, str(tmp / "port" / name), device="cpu", env=ENV, edit=edit)
    return tmp, logs


@pytest.mark.parametrize("name,out", [
    ("bandit_variants", "out"), ("price_optimize", "out"),
    ("price_optimize", "agg")])
def test_bandit_runbooks_match_reference(bandit_runbooks, name, out):
    tmp, logs = bandit_runbooks
    got = _read(tmp / "port" / name / "work" / out)
    assert got and got == _read(tmp / "jax" / name / "work" / out)
    summary = [l for l in logs[("port", name)].splitlines()
               if "true best price" in l]
    assert summary and summary == [
        l for l in logs[("jax", name)].splitlines()
        if "true best price" in l]


def test_price_optimize_runbook_fails_alike_without_the_edit(tmp_path):
    """The runbook as shipped dies in round 1 in both packages: the
    reader's validation refuses the ``inc_return1.txt`` that the
    ``_MANIFEST`` of ``work/in`` does not list."""
    src = os.path.join(REPO, "resource", "price_optimize")
    msgs = []
    for tag, kw in (("jax", {"port": False}), ("port", {"device": "cpu"})):
        with pytest.raises(RuntimeError) as ei:
            run_runbook(src, str(tmp_path / tag), env=ENV, **kw)
        msgs.append(re.findall(r"TornArtifactError: (work/in: part \S+ is "
                               r"not in _MANIFEST)", str(ei.value)))
    assert msgs[0] == msgs[1] == [
        "work/in: part inc_return1.txt is not in _MANIFEST"]
