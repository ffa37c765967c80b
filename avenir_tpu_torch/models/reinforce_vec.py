"""Vectorized multi-learner engine: a fleet of per-entity learners stepped
as dense ``[group, action]`` tensors on one device.

The port of ``avenir_tpu/models/reinforce_vec.py``.  The scalar library
(``models.reinforce``) holds one learner object per entity; with
thousands of entities that is a host loop per event.  This module keeps
the same learner math as masked steps over ``[G, A]`` tensors:

- state: per-arm trial counts, reward (count, sum) running stats, per-group
  total trial counts, and for ``softMax`` the temperature, the sampling
  probabilities and the rewarded latch;
- ``upperConfidenceBoundOne`` is deterministic (same scores, first-max /
  first-min ties, the min-trial bootstrap);
- ``randomGreedy`` explores with ``uniform`` and ``randint`` draws and
  ``softMax`` samples with ``categorical``, both from jax's threefry
  (``ops.threefry``) under the same keys as the reference, so every
  selection and every state tensor equals the reference's step by step.

The reference advances its state in one jitted ``lax.scan`` over
``split(key, n_steps)``; here a Python loop runs the same step body over
the same split keys in the same order.  Its float32 math rounds as XLA's
does: ``log`` and ``exp`` are ``ops.xla_math``'s, ``sqrt`` is the
correctly rounded one, softmax sums its row left to right, a reward
scatter adds duplicate (group, action) entries in arrival order, every
Python constant is rounded to float32 first (jax's weak types), and every
division is of two tensors (a CUDA card divides by a Python scalar as a
multiply by its reciprocal).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import threefry
from ..ops.xla_math import exp_f32, log_f32, sqrt_rn
from .reinforce import _cfg, _cfg_float, _cfg_int

_SUPPORTED = ("upperConfidenceBoundOne", "randomGreedy", "softMax")

F32 = torch.float32
I32 = torch.int32


def _f32(x: float) -> float:
    """A Python constant as the float32 that jax's weak typing makes it."""
    return float(np.float32(x))


def _arrival_ranks(keys: np.ndarray) -> np.ndarray:
    """For each entry, how many earlier entries share its key: a scatter
    run rank by rank adds duplicates in arrival order on any device."""
    ranks = np.zeros(len(keys), np.int64)
    seen: Dict[int, int] = {}
    for i, k in enumerate(keys.tolist()):
        ranks[i] = seen.get(k, 0)
        seen[k] = ranks[i] + 1
    return ranks


def _scatter_add_ordered(dst: torch.Tensor, g: np.ndarray, a: np.ndarray,
                         vals: torch.Tensor) -> torch.Tensor:
    """``dst.at[g, a].add(vals)`` out of place, duplicates added in
    arrival order (``vals`` on ``dst``'s device, one per entry)."""
    out = dst.clone()
    ranks = _arrival_ranks(g.astype(np.int64) * dst.shape[1] + a)
    dev = dst.device
    for r in range(int(ranks.max(initial=-1)) + 1):
        sel = np.nonzero(ranks == r)[0]
        idx = torch.from_numpy(sel).to(dev)
        out.index_put_((torch.from_numpy(g[sel].astype(np.int64)).to(dev),
                        torch.from_numpy(a[sel].astype(np.int64)).to(dev)),
                       vals[idx], accumulate=True)
    return out


class VectorizedLearnerGroup:
    """Dense ``[group, action]`` replacement for a ``ReinforcementLearner
    Group`` whose learners all share one type and config, on ``device``
    (``cuda:0`` unless the caller asks for another)."""

    def __init__(self, learner_type: str, group_ids: Sequence[str],
                 action_ids: Sequence[str], config: Optional[Dict] = None,
                 device=None):
        if learner_type not in _SUPPORTED:
            raise ValueError(
                f"unsupported vectorized learner type {learner_type!r}; "
                f"supported: {', '.join(_SUPPORTED)} (use the scalar "
                "ReinforcementLearnerGroup for the others)")
        config = config or {}
        self.learner_type = learner_type
        self.device = resolve_device(device)
        self.group_ids = list(group_ids)
        self.action_ids = list(action_ids)
        self._gindex = {g: i for i, g in enumerate(self.group_ids)}
        self._aindex = {a: i for i, a in enumerate(self.action_ids)}
        G, A = len(self.group_ids), len(self.action_ids)
        dev = self.device

        self.min_trial = _cfg_int(config, "min.trial", -1)
        self.batch_size = _cfg_int(config, "batch.size", 1)
        seed = _cfg_int(config, "random.seed", None)
        self._key = threefry.prng_key(0 if seed is None else seed, dev)

        # shared state (all types)
        self.trials = torch.zeros((G, A), dtype=I32, device=dev)
        self.rcnt = torch.zeros((G, A), dtype=I32, device=dev)
        self.rsum = torch.zeros((G, A), dtype=F32, device=dev)
        self.total = torch.zeros((G,), dtype=I32, device=dev)

        if learner_type == "upperConfidenceBoundOne":
            self.reward_scale = _cfg_int(config, "reward.scale", 100)
        else:
            self.reward_scale = _cfg_int(config, "reward.scale", 1)
        if learner_type == "randomGreedy":
            self.random_selection_prob = _cfg_float(
                config, "random.selection.prob", 0.5)
            self.prob_red_algorithm = _cfg(
                config, "prob.reduction.algorithm", "linear")
            if self.prob_red_algorithm not in ("none", "linear", "logLinear"):
                raise ValueError("Invalid probability reduction algorithm")
            self.prob_reduction_constant = _cfg_float(
                config, "prob.reduction.constant", 1.0)
            self.min_prob = _cfg_float(config, "min.prob", -1.0)
        if learner_type == "softMax":
            temp0 = self._temp0 = _cfg_float(config, "temp.constant", 100.0)
            self.min_temp_constant = _cfg_float(
                config, "min.temp.constant", -1.0)
            self.temp_red_algorithm = _cfg(
                config, "temp.reduction.algorithm", "linear")
            if self.temp_red_algorithm not in ("linear", "logLinear"):
                raise ValueError("Invalid temperature reduction algorithm")
            self.temp = torch.full((G,), temp0, dtype=F32, device=dev)
            self.probs = torch.full((G, A), 1.0 / A, dtype=F32, device=dev)
            self.rewarded = torch.zeros((G,), dtype=torch.bool, device=dev)
        self._body = {"upperConfidenceBoundOne": self._ucb1_step,
                      "randomGreedy": self._random_greedy_step,
                      "softMax": self._softmax_step}[learner_type]

    # -- per-type step bodies -------------------------------------------------
    # Each body advances only the groups where ``active`` is True (the
    # streaming case: an entity's learner steps when its event arrives).

    def _bootstrap(self, trials):
        """Least-tried arm while below min.trial; first-min tie order."""
        amin = torch.argmin(trials, dim=1)
        least = trials.gather(1, amin[:, None])[:, 0]
        take = (least <= self.min_trial) & (self.min_trial > 0)
        return amin, take

    @staticmethod
    def _avg(rcnt, rsum):
        return torch.where(rcnt > 0, rsum / rcnt.clamp_min(1),
                           torch.zeros_like(rsum))

    @staticmethod
    def _pull(trials, sel, active):
        rows = torch.arange(trials.shape[0], device=trials.device)
        out = trials.clone()
        out[rows, sel] += active.to(I32)
        return out

    def _ucb1_step(self, state, key, active):
        trials, rcnt, rsum, total = state
        total = total + active.to(I32)
        avg = self._avg(rcnt, rsum)
        t = total.clamp_min(1).to(F32)
        bonus = sqrt_rn(2.0 * log_f32(t)[:, None] / trials.clamp_min(1))
        score = torch.where(trials == 0, torch.full_like(avg, float("inf")),
                            avg + bonus)
        sel = torch.argmax(score, dim=1)
        amin, take = self._bootstrap(trials)
        sel = torch.where(take, amin, sel)
        return (self._pull(trials, sel, active), rcnt, rsum, total), sel

    def _random_greedy_step(self, state, key, active):
        trials, rcnt, rsum, total = state
        total = total + active.to(I32)
        t = total.clamp_min(1).to(F32)
        p0 = self.random_selection_prob
        scale = _f32(p0 * self.prob_reduction_constant)
        if self.prob_red_algorithm == "none":
            cur = torch.full_like(t, _f32(p0))
        elif self.prob_red_algorithm == "linear":
            cur = torch.full_like(t, scale) / t
        else:   # logLinear
            cur = scale * log_f32(t) / t
        cur = torch.clamp_max(cur, _f32(p0))
        if self.min_prob > 0:
            cur = torch.clamp_min(cur, _f32(self.min_prob))
        ku, kr = threefry.split(key).unbind(0)
        # the reference runs under x64: float64 uniforms, int64 randints
        u = threefry.uniform(ku, t.shape, torch.float64)
        explore = u < cur.to(torch.float64)
        rand_sel = threefry.randint(kr, t.shape, 0, len(self.action_ids))
        best = torch.argmax(self._avg(rcnt, rsum), dim=1)
        sel = torch.where(explore, rand_sel, best)
        amin, take = self._bootstrap(trials)
        sel = torch.where(take, amin, sel)
        return (self._pull(trials, sel, active), rcnt, rsum, total), sel

    def _softmax_step(self, state, key, active):
        trials, rcnt, rsum, total, temp, probs, rewarded = state
        total = total + active.to(I32)
        # a bootstrap step skips the whole sampler path: recompute, latch
        # reset and temperature decay live inside the scalar learner's
        # ``if action is None`` branch
        amin, take = self._bootstrap(trials)
        avg = self._avg(rcnt, rsum)
        shifted = (avg - avg.amax(dim=1, keepdim=True)) / temp[:, None]
        # jax.nn.softmax: exp(x - max) over a row sum taken left to right
        e = exp_f32(shifted - shifted.amax(dim=1, keepdim=True))
        tot = e[:, 0]
        for j in range(1, e.shape[1]):
            tot = tot + e[:, j]
        fresh = e / tot[:, None]
        recompute = rewarded & ~take & active
        probs = torch.where(recompute[:, None], fresh, probs)
        rewarded = rewarded & ~recompute
        sel = threefry.categorical(key, log_f32(probs), axis=1)
        sel = torch.where(take, amin, sel)
        # temperature decay: the divisor is total - min_trial with
        # min_trial's raw -1 default
        rnd = (total - self.min_trial).to(F32)
        decay_on = (rnd > 1) & ~take & active
        if self.temp_red_algorithm == "linear":
            newt = temp / rnd
        else:   # logLinear
            newt = temp * log_f32(rnd.clamp_min(1.0)) / rnd
        if self.min_temp_constant > 0:
            newt = torch.clamp_min(newt, _f32(self.min_temp_constant))
        newt = torch.clamp_min(newt, _f32(1e-12))   # underflow clamp
        temp = torch.where(decay_on, newt, temp)
        return ((self._pull(trials, sel, active), rcnt, rsum, total, temp,
                 probs, rewarded), sel)

    def _scan(self, state, keys, active):
        """The reference's ``lax.scan``: one step per key, in order;
        returns the state and the selections ``[n_steps, G]``."""
        sels = []
        for k in keys.unbind(0):
            state, sel = self._body(state, k, active)
            sels.append(sel)
        return state, torch.stack(sels)

    def _state(self):
        if self.learner_type == "softMax":
            return (self.trials, self.rcnt, self.rsum, self.total,
                    self.temp, self.probs, self.rewarded)
        return (self.trials, self.rcnt, self.rsum, self.total)

    def _set_state(self, state):
        if self.learner_type == "softMax":
            (self.trials, self.rcnt, self.rsum, self.total,
             self.temp, self.probs, self.rewarded) = state
        else:
            (self.trials, self.rcnt, self.rsum, self.total) = state

    @property
    def capacity(self) -> int:
        """Row count of the state tensors (>= len(group_ids); the surplus
        rows are unenrolled capacity, grown in powers of two)."""
        return int(self.trials.shape[0])

    def rows_for(self, ids: Sequence[str]) -> List[int]:
        """State-tensor row indices for the given group ids."""
        return [self._gindex[g] for g in ids]

    def add_groups(self, new_ids: Sequence[str]) -> None:
        """Grow the fleet with fresh learners (zeroed state, as a newly
        built scalar learner).  Capacity grows in powers of two; the
        unenrolled rows are never active and never emitted."""
        fresh = list(dict.fromkeys(
            g for g in new_ids if g not in self._gindex))
        if not fresh:
            return
        first_row = len(self.group_ids)
        for g in fresh:
            self._gindex[g] = len(self.group_ids)
            self.group_ids.append(g)
        if len(self.group_ids) > self.capacity:
            cap = max(8, self.capacity)
            while cap < len(self.group_ids):
                cap *= 2
            add = cap - self.capacity

            def pad(a, fill=0):
                return torch.cat([a, torch.full((add,) + tuple(a.shape[1:]),
                                                fill, dtype=a.dtype,
                                                device=a.device)])

            self.trials = pad(self.trials)
            self.rcnt = pad(self.rcnt)
            self.rsum = pad(self.rsum)
            self.total = pad(self.total)
            if self.learner_type == "softMax":
                self.temp = pad(self.temp, self._temp0)
                self.probs = pad(self.probs, 1.0 / len(self.action_ids))
                self.rewarded = pad(self.rewarded, False)
        # zero the enrolled rows: surplus rows advance under full-fleet
        # step() calls, so a recycled row is reset to a fresh learner
        rows = slice(first_row, len(self.group_ids))
        for name, fill in (("trials", 0), ("rcnt", 0), ("rsum", 0.0),
                           ("total", 0)):
            t = getattr(self, name).clone()
            t[rows] = fill
            setattr(self, name, t)
        if self.learner_type == "softMax":
            for name, fill in (("temp", self._temp0),
                               ("probs", 1.0 / len(self.action_ids)),
                               ("rewarded", False)):
                t = getattr(self, name).clone()
                t[rows] = fill
                setattr(self, name, t)

    # -- public surface ------------------------------------------------------

    def _split_key(self, n: int) -> torch.Tensor:
        keys = threefry.split(self._key, n)
        self._key = keys[0]
        return keys[1:]

    def step(self, n_steps: Optional[int] = None) -> np.ndarray:
        """Advance every learner ``n_steps`` times (default
        ``batch.size``); returns the selected action indices ``[n_steps,
        G]``."""
        n = self.batch_size if n_steps is None else n_steps
        sub = self._split_key(2)[0]
        active = torch.ones(self.capacity, dtype=torch.bool,
                            device=self.device)
        state, sels = self._scan(self._state(), threefry.split(sub, n),
                                 active)
        self._set_state(state)
        return sels.cpu().numpy()

    def step_masked(self, active: np.ndarray,
                    n_steps: int = 1) -> np.ndarray:
        """Advance only the groups where ``active`` is True, ``n_steps``
        times.  Returns the selected action indices ``[n_steps,
        capacity]``; entries of inactive groups are meaningless and their
        state is untouched."""
        return self.step_masked_async(active, n_steps).cpu().numpy()

    def step_masked_async(self, active: np.ndarray, n_steps: int = 1):
        """``step_masked`` without the host copy: the selections come back
        as a device tensor (queued work on a card)."""
        sub = self._split_key(2)[0]
        act = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        state, sels = self._scan(self._state(), threefry.split(sub, n_steps),
                                 act)
        self._set_state(state)
        return sels

    def step_waved_async(self, packed: np.ndarray, reward_bucket: int,
                         n_steps: int = 1):
        """One streaming wave: ``packed`` int32 ``[nr, nw, g[rb], a[rb],
        r[rb], rows[wb]]`` applies the bulk reward scatter (entries past
        ``nr`` are padding), then runs ``n_steps`` steps masked to the
        wave's rows (padding rows carry the capacity and drop).  The key
        splits into ``n_steps + 1``: the first is the next key, the rest
        drive the steps.  Returns the selections as a device tensor."""
        packed = np.asarray(packed, np.int32)
        rb = int(reward_bucket)
        nr = int(packed[0])
        g = packed[2:2 + nr]
        a = packed[2 + rb:2 + rb + nr]
        r = packed[2 + 2 * rb:2 + 2 * rb + nr]
        rows = packed[2 + 3 * rb:]
        if nr:
            # XLA turns the reference's division by the constant reward
            # scale into a multiply by its float32 reciprocal
            scale = (self.reward_scale
                     if self.learner_type == "upperConfidenceBoundOne" else 1)
            self._apply_rewards(g, a, r.astype(np.float32)
                                * (np.float32(1) / np.float32(scale)))
        act = np.zeros(self.capacity, bool)
        act[rows[rows < self.capacity]] = True
        keys = self._split_key(n_steps + 1)
        state, sels = self._scan(
            self._state(), keys, torch.from_numpy(act).to(self.device))
        self._set_state(state)
        return sels

    def _apply_rewards(self, g: np.ndarray, a: np.ndarray,
                       r: np.ndarray) -> None:
        """The reward scatter: ``rsum[g, a] += r`` (``r`` float32, already
        scaled), ``rcnt[g, a] += 1``, and the softMax rewarded latch."""
        vals = torch.from_numpy(np.asarray(r, np.float32)).to(self.device)
        self.rsum = _scatter_add_ordered(self.rsum, g, a, vals)
        self.rcnt = _scatter_add_ordered(
            self.rcnt, g, a, torch.ones(len(g), dtype=I32,
                                        device=self.device))
        if self.learner_type == "softMax":
            rewarded = self.rewarded.clone()
            rewarded[torch.from_numpy(g.astype(np.int64)).to(
                self.device)] = True
            self.rewarded = rewarded

    def next_actions(self) -> List[List[str]]:
        """``batch.size`` action ids per group: ``[G][batch]``, the
        grouped ``ReinforcementLearner.next_actions``."""
        sels = self.step()
        return [[self.action_ids[a] for a in sels[:, g]]
                for g in range(len(self.group_ids))]

    def set_rewards(self, group_ids: Sequence[str],
                    action_ids: Sequence[str],
                    rewards: Sequence[float]) -> None:
        """Bulk reward application: one scatter per round."""
        g = np.asarray([self._gindex[x] for x in group_ids], np.int64)
        a = np.asarray([self._aindex[x] for x in action_ids], np.int64)
        r = np.asarray(rewards, np.float32)
        if self.learner_type == "upperConfidenceBoundOne":
            # only UCB1 scales its reward stats (models.reinforce
            # set_reward); randomGreedy and softMax add the raw reward
            r = r / self.reward_scale
        self._apply_rewards(g, a, r)
