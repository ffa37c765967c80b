"""Batch (round-based) multi-armed bandit jobs.

Reference surface being re-expressed (citations into the reference's Java sources):
- ``org.avenir.reinforce.GreedyRandomBandit`` — per-group ε-greedy batch
  selection with linear/logLinear ε decay or the AuerGreedy schedule
  (GreedyRandomBandit.java:76-302); input rows ``group,item,count,reward``
  grouped by group id, batch sizes from a ``group.item.count.path`` side file
  (:117-124), output ``group,item`` lines.
- ``org.avenir.reinforce.AuerDeterministic`` — UCB1 over normalized rewards
  ``reward/maxReward + sqrt(2 ln n / n_item)``, untried items first
  (AuerDeterministic.java:182-231).
- ``org.avenir.reinforce.SoftMaxBandit`` — Boltzmann sampling over
  ``exp((reward/maxReward)/T)`` scaled by 1000, untried items first
  (SoftMaxBandit.java:170-206).
- ``org.avenir.reinforce.RandomFirstGreedyBandit`` — pure exploration for the
  first ``explorationCount`` selections (position-cycling ranges via
  ``ExplorationCounter``), then pure exploitation of the top-reward items
  through a rank secondary sort (RandomFirstGreedyBandit.java:83-245,
  ExplorationCounter.java:27-118).

The reward feedback loop is EXTERNAL, exactly as in the reference: outputs
are scored by a simulator/real system, re-aggregated (chombo
RunningAggregator's role — see ``aggregate_rewards`` below), the round
counter ``current.round.num`` is bumped, and the job re-runs
(resource/price_optimize_tutorial.txt:29-63).

Deliberate divergence (same defect as RandomGreedyLearner — see
models.reinforce): the reference's ``if (curProb < Math.random()) select
random`` (GreedyRandomBandit.java:263,285) inverts the ε schedule so later
rounds get MORE random; we explore with the decaying probability.
Randomness is seeded via the ``random.seed`` config key.

The port's copy of ``avenir_tpu/models/bandit.py``.  The four batch
bandits are per-group selection logic over tiny per-group item lists (100
products in the price-optimization tutorial) driven from text files
between externally scored rounds, so they stay host NumPy, copied
operation for operation: the same float operations in the same order and
numpy's seeded generator give the reference's bytes.  Each job takes a
``device`` and resolves it, as the port's other jobs do, though only
``BanditFeedbackAggregator`` does device work: its posterior fold
(``stream.posterior``) runs on the card.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.config import JobConfig
from ..core.obs import traced_run
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..device import resolve_device


class GroupedItems:
    """Per-group (item, count, reward) list with selection helpers
    (reinforce/GroupedItems.java:31-145)."""

    def __init__(self):
        self.items: List[dict] = []

    def create_item(self, item_id: str, count: int, reward: int) -> None:
        self.items.append({"itemID": item_id, "count": count, "reward": reward})

    def size(self) -> int:
        return len(self.items)

    def collect_items_not_tried(self, batch_size: int) -> List[dict]:
        """Remove and return up to batch_size items with count==0
        (GroupedItems.java:94-113)."""
        collected = []
        remaining = []
        for it in self.items:
            if it["count"] == 0 and len(collected) < batch_size:
                collected.append(it)
            else:
                remaining.append(it)
        self.items = remaining
        return collected

    def select_random(self, rng: np.random.Generator) -> dict:
        return self.items[int(rng.integers(len(self.items)))]

    def get_max_reward_item(self) -> Optional[dict]:
        """Max strictly-positive reward; None when nothing has been rewarded
        (GroupedItems.java:130-143 starts its max at 0)."""
        best, best_reward = None, 0
        for it in self.items:
            if it["reward"] > best_reward:
                best, best_reward = it, it["reward"]
        return best

    def remove(self, item: dict) -> None:
        self.items.remove(item)

    def add(self, item: dict) -> None:
        self.items.append(item)


def _read_grouped(in_path: str, delim_regex: str, count_ord: int,
                  reward_ord: int) -> "OrderedDict[str, GroupedItems]":
    """Rows ``group,item,...`` -> per-group item lists, preserving first-seen
    group order (the reference streams grouped input through one mapper)."""
    groups: "OrderedDict[str, GroupedItems]" = OrderedDict()
    for line in read_lines(in_path):
        items = split_line(line, delim_regex)
        g = groups.setdefault(items[0], GroupedItems())
        g.create_item(items[1], int(items[count_ord]), int(items[reward_ord]))
    return groups


def _read_batch_sizes(path: Optional[str]) -> Dict[str, Tuple[int, ...]]:
    """group.item.count.path side file: ``group,batchSize`` (2 cols) or
    ``group,count,batchSize`` (3 cols, RandomFirstGreedyBandit)."""
    out: Dict[str, Tuple[int, ...]] = {}
    if not path:
        return out
    for line in read_lines(path):
        parts = split_line(line, ",")
        out[parts[0]] = tuple(int(v) for v in parts[1:])
    return out


class _BanditJobBase:
    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        seed = config.get_int("random.seed", None)
        self.rng = np.random.default_rng(seed)

    def _common(self):
        cfg = self.config
        return (cfg.field_delim_regex(), cfg.get("field.delim", ","),
                cfg.get_int("current.round.num", -1),
                cfg.must_int("count.ordinal"),
                cfg.must_int("reward.ordinal"),
                _read_batch_sizes(cfg.get("group.item.count.path")))

    @staticmethod
    def _batch_size(batch_sizes, group_id) -> int:
        if not batch_sizes:
            return 1
        try:
            return batch_sizes[group_id][-1]
        except KeyError:
            raise ValueError(
                f"group {group_id!r} present in the input but missing from "
                f"the group.item.count.path side file") from None
        except IndexError:
            raise ValueError(
                f"group {group_id!r} line in the group.item.count.path side "
                f"file has no batch-size column") from None


class GreedyRandomBandit(_BanditJobBase):
    """ε-greedy batch bandit (GreedyRandomBandit.java:76-302)."""

    PROB_RED_LINEAR = "linear"
    PROB_RED_LOG_LINEAR = "logLinear"
    AUER_GREEDY = "AuerGreedy"

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        (delim_regex, delim, round_num, count_ord, reward_ord,
         batch_sizes) = self._common()
        algo = cfg.get("prob.reduction.algorithm", self.PROB_RED_LINEAR)
        rand_prob = cfg.get_float("random.selection.prob", 0.5)
        red_const = cfg.get_float("prob.reduction.constant", 1.0)
        auer_const = cfg.get_int("auer.greedy.constant", 5)

        groups = _read_grouped(in_path, delim_regex, count_ord, reward_ord)
        out = []
        for group_id, grouped in groups.items():
            batch = self._batch_size(batch_sizes, group_id)
            if algo in (self.PROB_RED_LINEAR, self.PROB_RED_LOG_LINEAR):
                selected = self._linear_select(
                    grouped, batch, round_num, rand_prob, red_const,
                    log_linear=(algo == self.PROB_RED_LOG_LINEAR))
            elif algo == self.AUER_GREEDY:
                selected = self._auer_greedy_select(
                    grouped, batch, round_num, auer_const)
            else:
                raise ValueError(f"invalid prob.reduction.algorithm:{algo}")
            for item in selected:
                out.append(f"{group_id}{delim}{item}")
                counters.incr("Bandit", "Selections")
        write_output(out_path, out)
        return counters

    def _linear_select(self, grouped: GroupedItems, batch_size: int,
                       round_num: int, rand_prob: float, red_const: float,
                       log_linear: bool) -> List[str]:
        selected: List[str] = []
        count = (round_num - 1) * batch_size
        n_avail = grouped.size()
        for _ in range(min(batch_size, n_avail)):
            count += 1
            # early rounds (count <= 1, incl. the unset round default -1)
            # explore at the full base probability instead of dividing by
            # zero / going negative
            t = max(count, 1)
            if log_linear:
                cur_prob = rand_prob * red_const * math.log(t) / t
            else:
                cur_prob = rand_prob * red_const / t
            cur_prob = min(cur_prob, rand_prob)
            # explore with the decaying prob, exploit otherwise (see module
            # docstring re the reference's flipped comparison); the picked
            # item leaves the pool so batch selections are distinct without
            # the reference's unbounded rejection loop
            # (GreedyRandomBandit.java:214-216)
            item = self._pick(grouped, cur_prob)
            selected.append(item["itemID"])
            grouped.remove(item)
        return selected

    def _pick(self, grouped: GroupedItems, cur_prob: float) -> dict:
        if self.rng.random() < cur_prob:
            return grouped.select_random(self.rng)
        best = grouped.get_max_reward_item()
        if best is None:  # nothing rewarded yet -> random
            return grouped.select_random(self.rng)
        return best

    def _auer_greedy_select(self, grouped: GroupedItems, batch_size: int,
                            round_num: int, auer_const: int) -> List[str]:
        """ε_t = cK/(d²t) schedule (GreedyRandomBandit.java:233-275)."""
        selected: List[str] = []
        count = (round_num - 1) * batch_size
        group_count = grouped.size()

        for it in grouped.collect_items_not_tried(batch_size):
            selected.append(it["itemID"])
        count += len(selected)

        if len(selected) < batch_size and grouped.size() > 0:
            max_item = grouped.get_max_reward_item()
            reward_diff = 1.0
            if max_item is not None and grouped.size() > 1:
                max_reward = max_item["reward"]
                grouped.remove(max_item)
                next_item = grouped.get_max_reward_item()
                next_reward = next_item["reward"] if next_item else 0
                grouped.add(max_item)
                if max_reward > 0:
                    reward_diff = (max_reward - next_reward) / max_reward
            reward_diff = max(reward_diff, 1e-9)
            while len(selected) < batch_size and grouped.size() > 0:
                prob = (auer_const * group_count
                        / (reward_diff * reward_diff * max(count, 1)))
                prob = min(prob, 1.0)
                if self.rng.random() < prob:
                    item = grouped.select_random(self.rng)
                else:
                    item = grouped.get_max_reward_item()
                    if item is None:
                        item = grouped.select_random(self.rng)
                selected.append(item["itemID"])
                grouped.remove(item)
                count += 1
        return selected


class AuerDeterministic(_BanditJobBase):
    """Deterministic UCB1 batch bandit (AuerDeterministic.java:74-233)."""

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        (delim_regex, delim, round_num, count_ord, reward_ord,
         batch_sizes) = self._common()
        algo = cfg.get("det.algorithm", "AuerUBC1")
        if algo != "AuerUBC1":
            raise ValueError(f"invalid det.algorithm:{algo}")

        groups = _read_grouped(in_path, delim_regex, count_ord, reward_ord)
        out = []
        for group_id, grouped in groups.items():
            batch = self._batch_size(batch_sizes, group_id)
            selected: List[str] = []
            count = (round_num - 1) * batch
            for it in grouped.collect_items_not_tried(batch):
                selected.append(it["itemID"])
            count += len(selected)

            while len(selected) < batch and grouped.size() > 0:
                max_item = grouped.get_max_reward_item()
                max_reward = max_item["reward"] if max_item else 1
                # UCB over the remaining items, vectorized
                rewards = np.asarray([it["reward"] for it in grouped.items],
                                     dtype=float)
                trials = np.asarray([it["count"] for it in grouped.items],
                                    dtype=float)
                with np.errstate(divide="ignore"):
                    bonus = np.sqrt(2.0 * math.log(max(count, 2)) /
                                    np.maximum(trials, 1e-12))
                value = rewards / max(max_reward, 1) + bonus
                pick = grouped.items[int(np.argmax(value))]
                selected.append(pick["itemID"])
                grouped.remove(pick)
                count += 1

            for item in selected:
                out.append(f"{group_id}{delim}{item}")
                counters.incr("Bandit", "Selections")
        write_output(out_path, out)
        return counters


class SoftMaxBandit(_BanditJobBase):
    """Boltzmann batch bandit (SoftMaxBandit.java:76-208); distribution
    values scaled by 1000 as in the reference (DISTR_SCALE)."""

    DISTR_SCALE = 1000

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        (delim_regex, delim, round_num, count_ord, reward_ord,
         batch_sizes) = self._common()
        temp = cfg.get_float("temp.constant", 1.0)

        groups = _read_grouped(in_path, delim_regex, count_ord, reward_ord)
        out = []
        for group_id, grouped in groups.items():
            batch = self._batch_size(batch_sizes, group_id)
            selected: List[str] = []
            for it in grouped.collect_items_not_tried(batch):
                selected.append(it["itemID"])

            if grouped.size() > 0 and len(selected) < batch:
                max_item = grouped.get_max_reward_item()
                max_reward = max_item["reward"] if max_item else 1
                ids = [it["itemID"] for it in grouped.items]
                distr = np.asarray([it["reward"] / max(max_reward, 1)
                                    for it in grouped.items])
                # max-subtracted exponent keeps the int scaling in range at
                # cold temperatures (the reference's raw (int) cast saturates
                # at Integer.MAX_VALUE — SoftMaxBandit.java:187); shifting
                # leaves the softmax distribution unchanged
                scaled = (np.exp((distr - distr.max()) / temp)
                          * self.DISTR_SCALE).astype(np.int64)
                # floor at 1 so cold temperatures cannot zero an arm out of
                # the replace=False draw entirely
                scaled = np.maximum(scaled, 1)
                probs = scaled / scaled.sum()
                take = min(batch - len(selected), len(ids))
                picks = self.rng.choice(len(ids), size=take, replace=False,
                                        p=probs)
                selected.extend(ids[i] for i in picks)

            for item in selected:
                out.append(f"{group_id}{delim}{item}")
                counters.incr("Bandit", "Selections")
        write_output(out_path, out)
        return counters


class ExplorationCounter:
    """Position-cycling exploration schedule
    (reinforce/ExplorationCounter.java:27-118)."""

    def __init__(self, group_id: str, count: int, exploration_count: int,
                 batch_size: int):
        self.group_id = group_id
        self.count = count
        self.exploration_count = exploration_count
        self.batch_size = batch_size
        self.selections: List[Tuple[int, int]] = []

    def select_next_round(self, round_num: int) -> None:
        remaining = self.exploration_count - (round_num - 1) * self.batch_size
        self.selections = []
        if remaining > 0:
            beg = remaining % self.count
            end = beg + self.batch_size - 1
            if end >= self.count:
                self.selections = [(beg, self.count - 1), (0, end - self.count)]
            else:
                self.selections = [(beg, end)]

    def is_in_exploration(self) -> bool:
        return bool(self.selections)

    def should_explore(self, item_index: int) -> bool:
        return any(lo <= item_index <= hi for lo, hi in self.selections)


class RandomFirstGreedyBandit(_BanditJobBase):
    """Explore-first-then-exploit batch bandit
    (RandomFirstGreedyBandit.java:83-245).  Input rows ``group,item[,reward]``;
    the side file carries ``group,count,batchSize``.  During exploration,
    items are chosen by cycling positions; afterwards the top-reward items
    win (the reference's rank secondary sort becomes an argsort)."""

    RANK_MAX = 1000

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        delim = cfg.get("field.delim", ",")
        round_num = cfg.get_int("current.round.num", 2)
        strategy = cfg.get("exploration.count.strategy", "simple")
        if strategy == "simple":
            expl_factor = cfg.get_int("exploration.count.factor", 2)
        else:
            reward_diff = cfg.get_float("pac.reward.diff", 0.2)
            prob_diff = cfg.get_float("pac.prob.diff", 0.2)

        expl_counters: Dict[str, ExplorationCounter] = {}
        for line in read_lines(cfg.must("group.item.count.path")):
            parts = split_line(line, ",")
            group_id, count, batch = parts[0], int(parts[1]), int(parts[2])
            if strategy == "simple":
                expl_count = expl_factor * count
            else:  # PAC bound (RandomFirstGreedyBandit.java:143)
                expl_count = int(4.0 / (reward_diff * reward_diff)
                                 + math.log(2.0 * count / prob_diff))
            expl_counters[group_id] = ExplorationCounter(
                group_id, count, expl_count, batch)

        # group rows preserving in-group position (the mapper's curItemIndex)
        rows: "OrderedDict[str, List[List[str]]]" = OrderedDict()
        for line in read_lines(in_path):
            items = split_line(line, delim_regex)
            rows.setdefault(items[0], []).append(items)

        out = []
        for group_id, group_rows in rows.items():
            ec = expl_counters[group_id]
            ec.select_next_round(round_num)
            ranked: List[Tuple[int, str]] = []
            for idx, items in enumerate(group_rows):
                if ec.is_in_exploration():
                    rank = 1 if ec.should_explore(idx) else -1
                else:
                    rank = (self.RANK_MAX - int(items[2])
                            if len(items) > 2 else -1)
                if rank > 0:
                    ranked.append((rank, items[1]))
            # rank ascending = highest reward first (secondary sort order)
            ranked.sort(key=lambda t: t[0])
            for _, item in ranked[:ec.batch_size]:
                out.append(f"{group_id}{delim}{item}")
                counters.incr("Bandit", "Selections")
        write_output(out_path, out)
        return counters


class BanditFeedbackAggregator:
    """Batch replay of a reward-event log into per-arm posterior state,
    emitting one ``tenant,arm,pulls,rewardSum`` line per (tenant, arm)
    (``stream.posterior.posterior_lines``).

    Input rows are CSV reward events; ``stream.tenant.ordinal`` /
    ``stream.arm.ordinal`` / ``stream.reward.ordinal`` (defaults 0/1/2)
    map the columns, and tenants and arms come from the declared
    ``stream.tenants`` / ``stream.arms`` manifest.  Malformed events are
    skipped and counted.  Exports the shared-scan
    :class:`~avenir_tpu_torch.stream.posterior.FeedbackFoldSpec`, which the
    fold certificate (``core.algebra``, jid ``bandit_fb``) certifies."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    def fold_spec(self, out_path: str):
        """Export the shared-scan ``core.multiscan.FoldSpec``."""
        from ..stream.posterior import FeedbackFoldSpec

        return FeedbackFoldSpec(self.config, out_path)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        """Drive the FoldSpec over the input as the shared scan would
        (chunked encode, host-to-device copy, in-place fold), on this
        job's device or on ``mesh``, so the standalone run is the
        certified fold path."""
        from ..core import pipeline
        from ..core.multiscan import ChunkContext
        from ..parallel.mesh import make_mesh

        mesh = mesh if mesh is not None else make_mesh([self.device])
        cfg = self.config
        spec = self.fold_spec(out_path)
        delim = cfg.field_delim_regex()
        chunk_rows = cfg.pipeline_chunk_rows(
            default=pipeline.DEFAULT_CHUNK_ROWS)
        xfer = pipeline.ChunkTransfer(mesh=mesh)
        fold = None
        for raw, _idx, _end in pipeline.iter_byte_chunks_meta(
                in_path, chunk_rows):
            arrs = spec.encode(ChunkContext(raw, delim))
            if arrs is None:
                continue
            if fold is None:
                fold = pipeline.ChunkFold(
                    spec.local_fn, static_args=spec.static_args,
                    mesh=mesh)
            fold.fold(xfer(tuple(arrs)))
        return spec.finalize(fold.result() if fold is not None else None)


def aggregate_rewards(selection_reward_lines: List[str],
                      prev_state_lines: List[str],
                      delim: str = ",") -> List[str]:
    """Inter-round reward aggregation — the chombo ``RunningAggregator`` role
    in the bandit loop (price_optimize_tutorial.txt:44-56): merge this
    round's scored selections ``group,item,reward`` into the running
    ``group,item,count,rewardAvg`` state consumed by the next round."""
    state: Dict[Tuple[str, str], List[int]] = {}
    for line in prev_state_lines:
        g, item, count, avg = line.split(delim)[:4]
        state[(g, item)] = [int(count), int(avg)]
    for line in selection_reward_lines:
        g, item, reward = line.split(delim)[:3]
        cur = state.setdefault((g, item), [0, 0])
        total = cur[0] * cur[1] + int(reward)
        cur[0] += 1
        cur[1] = total // cur[0]
    return [f"{g}{delim}{item}{delim}{c}{delim}{r}"
            for (g, item), (c, r) in state.items()]
