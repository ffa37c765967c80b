"""Online reinforcement-learning (multi-armed bandit) learner library: the
port's copy of ``avenir_tpu/models/reinforce.py``, host NumPy in both
packages, so that the same seed gives the same selections.

Reference surface being re-expressed (citations into the reference's Java sources):
- abstract base ``org.avenir.reinforce.ReinforcementLearner`` — actions,
  batch selection, reward stats, min-trial bootstrapping
  (reinforce/ReinforcementLearner.java:35-167).
- the 10 concrete learners created by the string-keyed factory
  ``ReinforcementLearnerFactory`` (reinforce/ReinforcementLearnerFactory.java:35-63):
  intervalEstimator, sampsonSampler, optimisticSampsonSampler, randomGreedy,
  upperConfidenceBoundOne, upperConfidenceBoundTwo, softMax, actionPursuit,
  rewardComparison, exponentialWeight.
- ``Action`` value object (trial count + total reward;
  reinforce/Action.java:24-59).

These are tiny scalar state machines driven one event at a time by the
streaming loop (models.streaming, the Storm-topology replacement) — per-event
device dispatch would be pure overhead, so state lives in plain Python/NumPy,
vectorized over actions where the math allows.  The fleet-scale batch
selection path (thousands of independent learners advanced per step) is the
batch bandit jobs in models.bandit, which vectorize over groups.

Deliberate divergences from reference behavior (each a reference defect that
prevents convergence; the user-facing config surface is unchanged):
- ``randomGreedy``: the reference selects the BEST action with the decaying
  probability and random with its complement (`if (curProb < Math.random())
  select random` — RandomGreedyLearner.java:83-96), inverting the ε-greedy
  schedule so late rounds become fully random.  We explore (random) with the
  decaying ``curProb`` and exploit otherwise.
- ``findBestAction`` never updates its running max
  (ReinforcementLearner.java:157-166), returning an arbitrary action; we
  return the true argmax of average reward (used by ``actionPursuit``).

Randomness: every learner takes a seeded ``numpy.random.Generator``
(``random.seed`` config key) instead of global ``Math.random()`` — tests
assert statistical equivalence (SURVEY §7.3 item 5).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.stats import (AverageValue, CategoricalSampler, HistogramStat,
                          SimpleStat)


def _cfg(config: Dict, key: str, default=None, required: bool = False):
    """Dict/JobConfig-agnostic lookup with dotted keys (chombo
    ConfigUtility.getX equivalents; both dict and JobConfig expose .get)."""
    val = config.get(key)
    if val is None:
        if required and default is None:
            raise ValueError(f"missing required learner config: {key}")
        return default
    return val


def _cfg_int(config, key, default=None, required=False):
    v = _cfg(config, key, default, required)
    return v if v is None else int(v)


def _cfg_float(config, key, default=None, required=False):
    v = _cfg(config, key, default, required)
    return v if v is None else float(v)


class Action:
    """Bandit arm with trial/reward counters (reinforce/Action.java:24-59)."""

    def __init__(self, action_id: str):
        self.id = action_id
        self.trial_count = 0
        self.total_reward = 0

    def select(self) -> None:
        self.trial_count += 1

    def reward(self, reward: int) -> None:
        self.total_reward += reward

    def get_average_reward(self) -> float:
        return self.total_reward / self.trial_count if self.trial_count else 0

    def __repr__(self):
        return (f"Action({self.id!r}, trials={self.trial_count}, "
                f"reward={self.total_reward})")


class ReinforcementLearner:
    """Abstract base (reinforce/ReinforcementLearner.java:35-167)."""

    def __init__(self):
        self.actions: List[Action] = []
        self.batch_size = 1
        self.total_trial_count = 0
        self.min_trial = -1
        self.reward_stats: Dict[str, AverageValue] = {}
        self.rewarded = False
        self.reward_scale = 1
        self.rng: np.random.Generator = np.random.default_rng()

    def with_actions(self, action_ids: Sequence[str]) -> "ReinforcementLearner":
        self.actions = [Action(a) for a in action_ids]
        return self

    def with_batch_size(self, batch_size: int) -> "ReinforcementLearner":
        self.batch_size = batch_size
        return self

    def initialize(self, config: Dict) -> None:
        self.min_trial = _cfg_int(config, "min.trial", -1)
        self.batch_size = _cfg_int(config, "batch.size", 1)
        self.reward_scale = _cfg_int(config, "reward.scale", 1)
        seed = _cfg_int(config, "random.seed", None)
        self.rng = np.random.default_rng(seed)

    def next_actions(self) -> List[Action]:
        return [self.next_action() for _ in range(self.batch_size)]

    def next_action(self) -> Action:
        raise NotImplementedError

    def set_reward(self, action_id: str, reward: int) -> None:
        raise NotImplementedError

    def get_stat(self) -> str:
        return ""

    # -- helpers ------------------------------------------------------------
    def find_action(self, action_id: str) -> Optional[Action]:
        for a in self.actions:
            if a.id == action_id:
                return a
        return None

    def find_action_with_min_trial(self) -> Action:
        return min(self.actions, key=lambda a: a.trial_count)

    def select_action_based_on_min_trial(self) -> Optional[Action]:
        """Bootstrap: force the least-tried action until every arm has
        ``min.trial`` trials (ReinforcementLearner.java:142-152)."""
        if self.min_trial > 0:
            action = self.find_action_with_min_trial()
            if action.trial_count <= self.min_trial:
                return action
        return None

    def find_best_action(self) -> Action:
        """True argmax of average reward (the reference's loop never updates
        its max — ReinforcementLearner.java:157-166; see module docstring)."""
        best_id = max(self.reward_stats,
                      key=lambda a: self.reward_stats[a].get_avg_value())
        return self.find_action(best_id)

    def _select_random(self) -> Action:
        return self.actions[int(self.rng.integers(len(self.actions)))]


class RandomGreedyLearner(ReinforcementLearner):
    """ε-greedy with linear/log-linear ε decay and non-stationary floor
    (reinforce/RandomGreedyLearner.java:31-108)."""

    PROB_RED_NONE = "none"
    PROB_RED_LINEAR = "linear"
    PROB_RED_LOG_LINEAR = "logLinear"

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.random_selection_prob = _cfg_float(config, "random.selection.prob", 0.5)
        self.prob_red_algorithm = _cfg(config, "prob.reduction.algorithm",
                                       self.PROB_RED_LINEAR)
        self.prob_reduction_constant = _cfg_float(config, "prob.reduction.constant", 1.0)
        self.min_prob = _cfg_float(config, "min.prob", -1.0)
        for a in self.actions:
            self.reward_stats[a.id] = SimpleStat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            t = self.total_trial_count
            if self.prob_red_algorithm == self.PROB_RED_NONE:
                cur_prob = self.random_selection_prob
            elif self.prob_red_algorithm == self.PROB_RED_LINEAR:
                cur_prob = (self.random_selection_prob
                            * self.prob_reduction_constant / t)
            elif self.prob_red_algorithm == self.PROB_RED_LOG_LINEAR:
                cur_prob = (self.random_selection_prob
                            * self.prob_reduction_constant * math.log(t) / t)
            else:
                raise ValueError("Invalid probability reduction algorithm")
            cur_prob = min(cur_prob, self.random_selection_prob)
            if 0 < self.min_prob and cur_prob < self.min_prob:
                cur_prob = self.min_prob  # non-stationary reward floor
            if self.rng.random() < cur_prob:
                action = self._select_random()   # explore with decaying prob
            else:
                action = self.find_best_action() # exploit otherwise
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.find_action(action_id).reward(reward)


class UpperConfidenceBoundOneLearner(ReinforcementLearner):
    """UCB1: ``avgReward + sqrt(2 ln n / n_a)``; untried arms score +inf
    (Java divides by zero trial count — UpperConfidenceBoundOneLearner.java:58)."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.reward_scale = _cfg_int(config, "reward.scale", 100)
        for a in self.actions:
            self.reward_stats[a.id] = SimpleStat()

    def _ucb_score(self, action: Action) -> float:
        if action.trial_count == 0:
            return float("inf")
        return (self.reward_stats[action.id].get_avg_value()
                + math.sqrt(2.0 * math.log(self.total_trial_count)
                            / action.trial_count))

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            action = max(self.actions, key=self._ucb_score)
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward / self.reward_scale)
        self.find_action(action_id).reward(reward)


class UpperConfidenceBoundTwoLearner(ReinforcementLearner):
    """UCB2: epoch-based, ``a(t, tau) = (1+α) ln(e·t/τ) / (2τ)`` with
    τ = (1+α)^epochs (reinforce/UpperConfidenceBoundTwoLearner.java:54-96)."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.reward_scale = _cfg_int(config, "reward.scale", 100)
        self.alpha = _cfg_float(config, "ucb2.alpha", 0.1)
        self.num_epochs: Dict[str, int] = {a.id: 0 for a in self.actions}
        self.current_action: Optional[Action] = None
        self.epoch_size = 0
        self.epoch_trial_count = 0
        for a in self.actions:
            self.reward_stats[a.id] = SimpleStat()

    def _score(self, action: Action) -> float:
        reward = self.reward_stats[action.id].get_avg_value()
        epochs = self.num_epochs[action.id]
        tau = 1.0 if epochs == 0 else (1.0 + self.alpha) ** epochs
        a = ((1 + self.alpha)
             * math.log(math.e * self.total_trial_count / tau) / (2 * tau))
        return reward + math.sqrt(max(a, 0.0))

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            if (self.current_action is not None
                    and self.epoch_trial_count < self.epoch_size):
                action = self.current_action
                self.epoch_trial_count += 1
            else:
                if self.current_action is not None:
                    self.num_epochs[self.current_action.id] += 1
                action = max(self.actions, key=self._score)
                self.current_action = action
                epochs = self.num_epochs[action.id]
                size = round((1.0 + self.alpha) ** (epochs + 1)
                             - (1.0 + self.alpha) ** epochs)
                self.epoch_size = max(int(size), 1)
                self.epoch_trial_count = 0
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward / self.reward_scale)
        self.find_action(action_id).reward(reward)


class SampsonSamplerLearner(ReinforcementLearner):
    """Thompson-style sampling from each arm's empirical reward list
    (reinforce/SampsonSamplerLearner.java:33-100)."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.min_sample_size = _cfg_int(config, "min.sample.size", required=True)
        self.max_reward = _cfg_int(config, "max.reward", required=True)
        self.reward_distr: Dict[str, List[int]] = {a.id: [] for a in self.actions}

    def enforce(self, action_id: str, reward: int) -> int:
        return reward

    def next_action(self) -> Action:
        self.total_trial_count += 1
        best_id, best_reward = None, -1
        for action_id, rewards in self.reward_distr.items():
            if len(rewards) > self.min_sample_size:
                reward = rewards[int(self.rng.integers(len(rewards)))]
                reward = self.enforce(action_id, reward)
            else:
                reward = self.rng.random() * self.max_reward
            if reward > best_reward:
                best_id, best_reward = action_id, reward
        action = self.find_action(best_id)
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_distr[action_id].append(reward)
        self.find_action(action_id).reward(reward)


class OptimisticSampsonSamplerLearner(SampsonSamplerLearner):
    """Sampled reward floored at the arm's mean
    (reinforce/OptimisticSampsonSamplerLearner.java:30-54)."""

    def enforce(self, action_id: str, reward: int) -> int:
        rewards = self.reward_distr.get(action_id)
        if rewards:
            mean = sum(rewards) // len(rewards)
            return max(reward, mean)
        return reward


class IntervalEstimatorLearner(ReinforcementLearner):
    """Interval estimation on binned reward histograms with a shrinking
    confidence limit (reinforce/IntervalEstimatorLearner.java:35-172)."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.bin_width = _cfg_int(config, "bin.width", required=True)
        self.confidence_limit = _cfg_int(config, "confidence.limit", required=True)
        self.min_confidence_limit = _cfg_int(config, "min.confidence.limit",
                                             required=True)
        self.cur_confidence_limit = self.confidence_limit
        self.reduction_step = _cfg_int(config, "confidence.limit.reduction.step",
                                       required=True)
        self.reduction_round_interval = _cfg_int(
            config, "confidence.limit.reduction.round.interval", required=True)
        self.min_distr_sample = _cfg_int(config, "min.reward.distr.sample",
                                         required=True)
        self.reward_distr: Dict[str, HistogramStat] = {
            a.id: HistogramStat(self.bin_width) for a in self.actions}
        self.last_round_num = 1
        self.random_select_count = 0
        self.intv_est_select_count = 0
        self.low_sample = True

    def _adjust_conf_limit(self) -> None:
        if self.cur_confidence_limit > self.min_confidence_limit:
            red_step = ((self.total_trial_count - self.last_round_num)
                        // self.reduction_round_interval)
            if red_step > 0:
                self.cur_confidence_limit = max(
                    self.cur_confidence_limit - red_step * self.reduction_step,
                    self.min_confidence_limit)
                self.last_round_num = self.total_trial_count

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.low_sample:
            self.low_sample = any(
                s.get_count() < self.min_distr_sample
                for s in self.reward_distr.values())
            if not self.low_sample:
                self.last_round_num = self.total_trial_count
        if self.low_sample:
            action = self._select_random()
            self.random_select_count += 1
        else:
            self._adjust_conf_limit()
            best_id, best_ub = None, 0
            for action_id, stat in self.reward_distr.items():
                _, upper = stat.get_confidence_bounds(self.cur_confidence_limit)
                if upper > best_ub:
                    best_id, best_ub = action_id, upper
            action = self.find_action(best_id)
            self.intv_est_select_count += 1
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        stat = self.reward_distr.get(action_id)
        if stat is None:
            raise ValueError(f"invalid action:{action_id}")
        stat.add(reward)
        self.find_action(action_id).reward(reward)

    def get_stat(self) -> str:
        return (f"randomSelectCount:{self.random_select_count} "
                f"intvEstSelectCount:{self.intv_est_select_count}")


class SoftMaxLearner(ReinforcementLearner):
    """Boltzmann exploration with temperature decay
    (reinforce/SoftMaxLearner.java:32-123)."""

    TEMP_RED_LINEAR = "linear"
    TEMP_RED_LOG_LINEAR = "logLinear"

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.temp_constant = _cfg_float(config, "temp.constant", 100.0)
        self.min_temp_constant = _cfg_float(config, "min.temp.constant", -1.0)
        self.temp_red_algorithm = _cfg(config, "temp.reduction.algorithm",
                                       self.TEMP_RED_LINEAR)
        self.sampler = CategoricalSampler()
        for a in self.actions:
            self.reward_stats[a.id] = SimpleStat()
            self.sampler.add(a.id, 1.0 / len(self.actions))

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            if self.rewarded:
                self.sampler.initialize()
                # max-subtracted softmax: same distribution as the reference's
                # raw exp (SoftMaxLearner.java:79-85) without overflow once
                # the temperature has decayed
                max_avg = max(self.reward_stats[a.id].get_avg_value()
                              for a in self.actions)
                exp_distr = {
                    a.id: math.exp((self.reward_stats[a.id].get_avg_value()
                                    - max_avg) / self.temp_constant)
                    for a in self.actions}
                total = sum(exp_distr.values())
                for a in self.actions:
                    self.sampler.add(a.id, exp_distr[a.id] / total)
                self.rewarded = False
            action = self.find_action(self.sampler.sample(self.rng))
            # temperature decay (SoftMaxLearner.java:96-109); min_trial is
            # subtracted raw — it defaults to -1, so with min.trial unset the
            # divisor is totalTrialCount+1, exactly as in the reference
            soft_max_round = self.total_trial_count - self.min_trial
            if soft_max_round > 1:
                if self.temp_red_algorithm == self.TEMP_RED_LINEAR:
                    self.temp_constant /= soft_max_round
                elif self.temp_red_algorithm == self.TEMP_RED_LOG_LINEAR:
                    self.temp_constant *= (math.log(soft_max_round)
                                           / soft_max_round)
                if (self.min_temp_constant > 0
                        and self.temp_constant < self.min_temp_constant):
                    self.temp_constant = self.min_temp_constant
                # the cumulative decay underflows to 0.0 within ~170 rounds
                # when no floor is configured; clamp to a tiny positive
                # temperature (= argmax sampling) instead of dividing by zero
                if self.temp_constant <= 0.0:
                    self.temp_constant = 1e-12
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.find_action(action_id).reward(reward)
        self.rewarded = True


class ActionPursuitLearner(ReinforcementLearner):
    """Pursuit: push sampling probability toward the best arm
    (reinforce/ActionPursuitLearner.java:32-84)."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.learning_rate = _cfg_float(config, "pursuit.learning.rate", 0.05)
        self.sampler = CategoricalSampler()
        for a in self.actions:
            self.sampler.add(a.id, 1.0 / len(self.actions))
            self.reward_stats[a.id] = SimpleStat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.rewarded:
            best = self.find_best_action()
            for a in self.actions:
                distr = self.sampler.get(a.id)
                if a is best:
                    distr += self.learning_rate * (1.0 - distr)
                else:
                    distr -= self.learning_rate * distr
                self.sampler.set(a.id, distr)
            self.rewarded = False
        action = self.find_action(self.sampler.sample(self.rng))
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.rewarded = True
        self.find_action(action_id).reward(reward)


class RewardComparisonLearner(ReinforcementLearner):
    """Preference learning against a moving reference reward
    (reinforce/RewardComparisonLearner.java:32-105)."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.preference_change_rate = _cfg_float(config, "preference.change.rate", 0.01)
        self.ref_reward_change_rate = _cfg_float(config,
                                                 "reference.reward.change.rate", 0.01)
        self.ref_reward = _cfg_float(config, "intial.reference.reward", 100.0)
        self.sampler = CategoricalSampler()
        self.action_prefs: Dict[str, float] = {}
        for a in self.actions:
            self.sampler.add(a.id, 1.0 / len(self.actions))
            self.reward_stats[a.id] = SimpleStat()
            self.action_prefs[a.id] = 0.0

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.rewarded:
            self.sampler.initialize()
            max_pref = max(self.action_prefs.values())
            exp_distr = {a.id: math.exp(self.action_prefs[a.id] - max_pref)
                         for a in self.actions}
            total = sum(exp_distr.values())
            for a in self.actions:
                self.sampler.add(a.id, exp_distr[a.id] / total)
            self.rewarded = False
        action = self.find_action(self.sampler.sample(self.rng))
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.rewarded = True
        self.find_action(action_id).reward(reward)
        mean_reward = self.reward_stats[action_id].get_avg_value()
        self.action_prefs[action_id] += (self.preference_change_rate
                                         * (mean_reward - self.ref_reward))
        self.ref_reward += (self.ref_reward_change_rate
                            * (mean_reward - self.ref_reward))


class ExponentialWeightLearner(ReinforcementLearner):
    """EXP3: importance-weighted exponential weights
    (reinforce/ExponentialWeightLearner.java:32-86).  ``distr.constant`` is
    EXP3's γ ∈ (0, 1]; the reference defaults it to 100.0, which is outside
    the valid range — configure it explicitly."""

    def initialize(self, config: Dict) -> None:
        super().initialize(config)
        self.distr_constant = _cfg_float(config, "distr.constant", 0.1)
        self.weight_distr: Dict[str, float] = {a.id: 1.0 for a in self.actions}
        self.sampler = CategoricalSampler()
        for a in self.actions:
            self.sampler.add(a.id, 1.0 / len(self.actions))

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.rewarded:
            sum_wt = sum(self.weight_distr.values())
            self.sampler.initialize()
            k = len(self.actions)
            for a in self.actions:
                prob = ((1.0 - self.distr_constant)
                        * self.weight_distr[a.id] / sum_wt
                        + self.distr_constant / k)
                self.sampler.add(a.id, prob)
            self.rewarded = False
        action = self.find_action(self.sampler.sample(self.rng))
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.find_action(action_id).reward(reward)
        scaled = reward / self.reward_scale
        exponent = (self.distr_constant * (scaled / self.sampler.get(action_id))
                    / len(self.actions))
        self.weight_distr[action_id] *= math.exp(min(exponent, 700.0))
        # renormalize: the sampling probabilities only see weight ratios, so
        # dividing by the sum is behavior-neutral and prevents the unbounded
        # growth that overflows the reference (ExponentialWeightLearner.java:81)
        total = sum(self.weight_distr.values())
        for k in self.weight_distr:
            self.weight_distr[k] /= total
        self.rewarded = True


_LEARNERS = {
    "intervalEstimator": IntervalEstimatorLearner,
    "sampsonSampler": SampsonSamplerLearner,
    "optimisticSampsonSampler": OptimisticSampsonSamplerLearner,
    "randomGreedy": RandomGreedyLearner,
    "upperConfidenceBoundOne": UpperConfidenceBoundOneLearner,
    "upperConfidenceBoundTwo": UpperConfidenceBoundTwoLearner,
    "softMax": SoftMaxLearner,
    "actionPursuit": ActionPursuitLearner,
    "rewardComparison": RewardComparisonLearner,
    "exponentialWeight": ExponentialWeightLearner,
}


def create_learner(learner_type: str, actions: Sequence[str],
                   config: Dict) -> ReinforcementLearner:
    """String-keyed factory preserving the reference's learner-type names
    (reinforce/ReinforcementLearnerFactory.java:35-63)."""
    cls = _LEARNERS.get(learner_type)
    if cls is None:
        raise ValueError(f"invalid learner type:{learner_type}")
    learner = cls().with_actions(actions)
    learner.initialize(config)
    return learner


class ReinforcementLearnerFactory:
    """Class-shaped alias mirroring the reference entry point."""

    @staticmethod
    def create(learner_type: str, actions: Sequence[str],
               config: Dict) -> ReinforcementLearner:
        return create_learner(learner_type, actions, config)


class ReinforcementLearnerGroup:
    """Per-entity learner map (reinforce/ReinforcementLearnerGroup.java:30-70):
    one independent learner per entity id (user, product, campaign ...), all
    built by the factory from shared config.  Config keys match the
    reference: ``learner.type`` (default ``randomGreedy``) and the required
    ``action.list`` comma list.
    """

    def __init__(self, config: Dict):
        self.config = config
        self.learner_type = _cfg(config, "learner.type", "randomGreedy")
        actions = _cfg(config, "action.list", required=True)
        self.actions = (actions.split(",")
                        if isinstance(actions, str) else list(actions))
        self.learners: Dict[str, ReinforcementLearner] = {}

    def add_learner(self, learner_id: str) -> ReinforcementLearner:
        learner = create_learner(self.learner_type, self.actions, self.config)
        self.learners[learner_id] = learner
        return learner

    def get_learner(self, learner_id: str) -> Optional[ReinforcementLearner]:
        return self.learners.get(learner_id)

    def _require(self, learner_id: str) -> ReinforcementLearner:
        learner = self.learners.get(learner_id)
        if learner is None:
            raise ValueError(
                f"unknown learner id {learner_id!r}; call add_learner first "
                f"(known: {sorted(self.learners)[:10]})")
        return learner

    def next_actions(self, learner_id: str) -> List[Action]:
        return self._require(learner_id).next_actions()

    def set_reward(self, learner_id: str, action_id: str, reward: int) -> None:
        self._require(learner_id).set_reward(action_id, reward)
