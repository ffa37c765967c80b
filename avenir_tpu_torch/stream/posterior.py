"""Per-(tenant, arm) bandit posterior state: the fold half of
``avenir_tpu/stream/posterior.py``.

Every tenant owns one row of per-arm sufficient statistics, pull counts
and reward sums.  Reward events fold in as scatter-adds
(:func:`_posterior_local`, the ``core.pipeline.ChunkFold`` ``local_fn``
contract), and two carries combine by elementwise add
(``core.multiscan.merge_carries``), a commutative monoid that
``core.algebra`` certifies through :class:`FeedbackFoldSpec` (jid
``bandit_fb``).

This module holds what the batch replay job
(``models.bandit.BanditFeedbackAggregator``) needs: the fold, the event
parser, the canonical posterior lines, the tenant and arm manifests and
the shared-scan FoldSpec.  The decide path (``_ucb_decide``,
``_thompson_decide`` with its threefry draws), ``ArmPosterior`` and the
live ``PosteriorStore`` come with the stream tier (ROADMAP queue 1 item
4).

Config surface (``stream.*``): ``stream.tenants`` /
``stream.tenants.path`` (tenant manifest), ``stream.arms``,
``stream.posterior.dtype`` (``float64`` | ``float32``), and the column
mapping ``stream.tenant.ordinal`` / ``stream.arm.ordinal`` /
``stream.reward.ordinal``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.io import read_lines, write_output
from ..core.metrics import Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..ops.counting import count_table

KEY_TENANTS = "stream.tenants"
KEY_TENANTS_PATH = "stream.tenants.path"
KEY_ARMS = "stream.arms"
KEY_DTYPE = "stream.posterior.dtype"
KEY_TENANT_ORD = "stream.tenant.ordinal"
KEY_ARM_ORD = "stream.arm.ordinal"
KEY_REWARD_ORD = "stream.reward.ordinal"

DEFAULT_DTYPE = "float64"

STREAM_GROUP = "Stream"

#: strict integer reward syntax (int() alone would admit '1_0' or ' 10')
_INT_RE = re.compile(r"-?\d+", re.ASCII)

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _posterior_local(t, a, r, mask, n_tenants, n_arms, dtype_name,
                     out=None):
    """One chunk's fold: scatter the (tenant, arm, reward) triples into
    ``{"pulls": [T, A] int64, "reward": [T, A] <dtype>}``, added into
    ``out`` in place when given.  Masked or out-of-range rows add
    nothing.

    Rewards are integers, so every float64 reward sum is exact while its
    magnitude stays below 2**53: ``index_add_``'s order on the card (its
    atomics land in any order) then cannot change a bit, and the sums
    equal the reference's.  float32 sums are exact below 2**24."""
    sizes = (n_tenants, n_arms)
    part = {
        "pulls": count_table(sizes, (t, a), mask=mask, dtype=torch.int64),
        "reward": count_table(sizes, (t, a), weights=r, mask=mask,
                              dtype=_TORCH_DTYPES[dtype_name]),
    }
    if out is None:
        return part
    out["pulls"] += part["pulls"]
    out["reward"] += part["reward"]
    return out


def parse_event(fields: Sequence[str], t_ord: int, a_ord: int, r_ord: int,
                tenant_index: Dict[str, int], arm_index: Dict[str, int]
                ) -> Optional[Tuple[int, int, int]]:
    """One reward event's (tenant idx, arm idx, reward), or None for a
    malformed event (short row, unknown tenant or arm, non-integer
    reward)."""
    need = max(t_ord, a_ord, r_ord) + 1
    if len(fields) < need:
        return None
    ti = tenant_index.get(str(fields[t_ord]))
    ai = arm_index.get(str(fields[a_ord]))
    rs = str(fields[r_ord])
    if ti is None or ai is None or not _INT_RE.fullmatch(rs):
        return None
    return ti, ai, int(rs)


def posterior_lines(tenants: Sequence[str], arms: Sequence[str],
                    pulls: np.ndarray, reward: np.ndarray,
                    delim: str = ",") -> List[str]:
    """The canonical posterior emission: one ``tenant,arm,pulls,
    rewardSum`` line per (tenant, arm), in manifest order."""
    out = []
    for i, tenant in enumerate(tenants):
        for j, arm in enumerate(arms):
            out.append(f"{tenant}{delim}{arm}{delim}{int(pulls[i, j])}"
                       f"{delim}{float(reward[i, j])!r}")
    return out


def _dtype_from_name(name: str) -> np.dtype:
    if name not in _TORCH_DTYPES:
        raise ValueError(
            f"{KEY_DTYPE} must be float32 or float64: {name!r}")
    return np.dtype(name)


def tenants_from_config(config) -> List[str]:
    """The declared tenant manifest: the inline ``stream.tenants`` list,
    or one tenant id per line of ``stream.tenants.path``.  Declared, never
    discovered, so carry shapes are fixed."""
    inline = config.get(KEY_TENANTS)
    if inline:
        names = [s.strip() for s in inline.split(",") if s.strip()]
    else:
        path = config.get(KEY_TENANTS_PATH)
        if not path:
            raise KeyError(
                f"missing tenant manifest: set {KEY_TENANTS} or "
                f"{KEY_TENANTS_PATH}")
        names = [l.strip() for l in read_lines(path) if l.strip()]
    if not names:
        raise ValueError(f"{KEY_TENANTS} is empty")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant ids in {KEY_TENANTS}")
    return names


def arms_from_config(config) -> List[str]:
    names = [s.strip() for s in config.must(KEY_ARMS).split(",")
             if s.strip()]
    if len(names) < 2:
        raise ValueError(f"{KEY_ARMS} needs at least two arms: {names}")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate arm ids in {KEY_ARMS}")
    return names


class FeedbackFoldSpec(MultiScanFoldSpec):
    """Shared-scan FoldSpec replaying a ``tenant,arm,reward`` event CSV
    into per-arm posterior state.  The manifests are declared, so
    ``static_args`` are fixed at construction; malformed events are
    skipped and counted (:func:`parse_event`).  Rewards are integers, so
    the float sums are exact under every chunking and merge order."""

    fixed_capacity = False

    def __init__(self, config, out_path: str):
        self.out_path = out_path
        self.name = "FeedbackFold"
        self.tenants = tenants_from_config(config)
        self.arms = arms_from_config(config)
        self.tenant_index = {t: i for i, t in enumerate(self.tenants)}
        self.arm_index = {a: i for i, a in enumerate(self.arms)}
        self.dtype = _dtype_from_name(config.get(KEY_DTYPE, DEFAULT_DTYPE))
        self.t_ord = config.get_int(KEY_TENANT_ORD, 0)
        self.a_ord = config.get_int(KEY_ARM_ORD, 1)
        self.r_ord = config.get_int(KEY_REWARD_ORD, 2)
        self.delim_out = config.field_delim_out()
        self.local_fn = _posterior_local
        self.static_args = (len(self.tenants), len(self.arms),
                            str(self.dtype))
        self.malformed = 0
        self.events = 0

    def encode(self, ctx):
        t_idx, a_idx, rewards = [], [], []
        for fields in ctx.fields():
            ev = parse_event(fields, self.t_ord, self.a_ord, self.r_ord,
                             self.tenant_index, self.arm_index)
            if ev is None:
                self.malformed += 1
                continue
            t_idx.append(ev[0])
            a_idx.append(ev[1])
            rewards.append(ev[2])
        if not t_idx:
            return None
        self.events += len(t_idx)
        return (np.asarray(t_idx, np.int32), np.asarray(a_idx, np.int32),
                np.asarray(rewards, np.int64))

    def finalize(self, carry) -> Counters:
        counters = Counters()
        if carry is None:
            pulls = np.zeros((len(self.tenants), len(self.arms)), np.int64)
            reward = np.zeros_like(pulls, dtype=self.dtype)
        else:
            pulls = np.asarray(carry["pulls"])
            reward = np.asarray(carry["reward"])
        write_output(self.out_path, posterior_lines(
            self.tenants, self.arms, pulls, reward, self.delim_out))
        counters.set(STREAM_GROUP, "Events folded", self.events)
        counters.set(STREAM_GROUP, "Malformed events", self.malformed)
        return counters
