"""Per-(tenant, arm) bandit posterior state: the port of
``avenir_tpu/stream/posterior.py``.

Every tenant owns one row of per-arm sufficient statistics, pull counts
and reward sums.  Reward events fold in as scatter-adds
(:func:`_posterior_local`, the ``core.pipeline.ChunkFold`` ``local_fn``
contract), and two carries combine by elementwise add
(``core.multiscan.merge_carries``), a commutative monoid that
``core.algebra`` certifies through :class:`FeedbackFoldSpec` (jid
``bandit_fb``).  Rewards are integers on the wire, so the float sums are
exact in any order.

Three layers:

- :class:`ArmPosterior`: the host-form state value (``state_dict`` /
  ``from_state`` / ``merge``) and the canonical emitted lines shared by
  the batch aggregator and the streaming audit.
- :class:`PosteriorStore`: the live store on one device (``cuda:0``
  unless the caller asks for another).  The feedback consumer folds
  event batches in out of place and swaps the ``(pulls, reward)`` pair
  under the store's lock; the decide path reads that pair under the same
  lock, so a decision never sees two folds' halves.  Decisions are
  Thompson sampling or UCB (:func:`_thompson_decide`,
  :func:`_ucb_decide`) with jax's threefry draws (``ops.threefry``) and
  XLA's float math (``ops.xla_math``), so a decision is a pure function
  of (posterior, seed, event id), equal to the reference's bit for bit.
  On a CUDA card the eager chain (about 3,270 launches for a Thompson
  decide of float64 draws) is captured once per request bucket into a
  CUDA graph (``utils.graphs.GraphedCall``) and replayed: the same
  kernels with the same arguments, so the same bits, in one launch.
- :class:`FeedbackFoldSpec`: the shared-scan FoldSpec replaying a
  reward-event CSV log, the batch twin of the online consumer.

Config surface (``stream.*``): ``stream.tenants`` /
``stream.tenants.path`` (tenant manifest), ``stream.arms``,
``stream.algorithm`` (``thompson`` | ``ucb``), ``stream.seed``,
``stream.thompson.sigma``, ``stream.posterior.dtype`` (``float64`` |
``float32``), ``stream.store`` (the process-local store registry key),
and the batch-replay column mapping ``stream.tenant.ordinal`` /
``stream.arm.ordinal`` / ``stream.reward.ordinal``.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import sanitizer, telemetry
from ..core.io import read_lines, write_output
from ..core.metrics import Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..ops import threefry
from ..ops.counting import count_table
from ..ops.xla_math import fma_f32, fma_f64, log_f32, log_f64, sqrt_rn
from ..utils.graphs import GraphedCall

KEY_TENANTS = "stream.tenants"
KEY_TENANTS_PATH = "stream.tenants.path"
KEY_ARMS = "stream.arms"
KEY_ALGORITHM = "stream.algorithm"
KEY_SEED = "stream.seed"
KEY_SIGMA = "stream.thompson.sigma"
KEY_DTYPE = "stream.posterior.dtype"
KEY_STORE = "stream.store"
KEY_TENANT_ORD = "stream.tenant.ordinal"
KEY_ARM_ORD = "stream.arm.ordinal"
KEY_REWARD_ORD = "stream.reward.ordinal"

DEFAULT_SEED = 2026
DEFAULT_SIGMA = 1.0
DEFAULT_DTYPE = "float64"
DEFAULT_STORE = "default"

ALGO_THOMPSON = "thompson"
ALGO_UCB = "ucb"

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


def _ucb_decide(pulls: torch.Tensor, reward: torch.Tensor,
                tid: torch.Tensor) -> torch.Tensor:
    """Deterministic UCB1 over normalized posterior means: untried arms
    first (infinite bonus; ties go to the lowest arm index), else ``mean
    + sqrt(2 ln N_tenant / n_arm)``, with XLA's ``log``."""
    n = pulls[tid].to(reward.dtype)                        # [B, A]
    nmax = n.clamp_min(1.0)
    mean = reward[tid] / nmax
    total = pulls.sum(dim=1).clamp_min(1)[tid].to(reward.dtype)
    log = log_f64 if reward.dtype == torch.float64 else log_f32
    bonus = sqrt_rn(2.0 * log(total)[:, None] / nmax)
    val = torch.where(n == 0, torch.full_like(n, float("inf")),
                      mean + bonus)
    return torch.argmax(val, dim=1)


def _thompson_decide(pulls: torch.Tensor, reward: torch.Tensor,
                     tid: torch.Tensor, crc: torch.Tensor, seed: int,
                     sigma: float) -> torch.Tensor:
    """Gaussian Thompson sampling: per arm a draw ``N(mean, sigma /
    sqrt(n + 1))``, the row's key ``fold_in(PRNGKey(seed), crc)`` (the
    event id's CRC32), so a decision depends on (posterior, seed, event
    id) only, never on the batch it came in.  ``mean + sd * z`` is one
    FMA, as XLA contracts it."""
    n = pulls[tid].to(reward.dtype)                        # [B, A]
    mean = reward[tid] / n.clamp_min(1.0)
    # a tensor over a tensor: a CUDA card's division by (or of) a Python
    # scalar multiplies by a reciprocal, a second rounding
    sd = torch.full_like(n, sigma) / sqrt_rn(n + 1.0)
    keys = threefry.fold_in(threefry.prng_key(seed, reward.device), crc)
    z = threefry.normal(keys, (mean.shape[1],), reward.dtype)
    fma = fma_f64 if reward.dtype == torch.float64 else fma_f32
    return torch.argmax(fma(sd, z, mean), dim=1)


def event_crc(event_id: str) -> int:
    """The per-decision RNG discriminator: CRC32 of the event id (stable
    across processes and platforms)."""
    return zlib.crc32(event_id.encode("utf-8"))


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


class ArmPosterior:
    """Host-form per-(tenant, arm) posterior state, the monoid value.

    ``merge`` is elementwise add over identical manifests;
    ``state_dict`` / ``from_state`` round-trip it for checkpoints.
    Rewards are integer-valued, so merges are exact in any order."""

    __slots__ = ("tenants", "arms", "pulls", "reward")

    def __init__(self, tenants: Sequence[str], arms: Sequence[str],
                 pulls: Optional[np.ndarray] = None,
                 reward: Optional[np.ndarray] = None,
                 dtype: np.dtype = np.dtype(DEFAULT_DTYPE)):
        self.tenants = list(tenants)
        self.arms = list(arms)
        shape = (len(self.tenants), len(self.arms))
        self.pulls = (np.zeros(shape, np.int64) if pulls is None
                      else np.asarray(pulls, np.int64).reshape(shape))
        self.reward = (np.zeros(shape, dtype) if reward is None
                       else np.asarray(reward, dtype).reshape(shape))

    def state_dict(self) -> dict:
        return {"tenants": list(self.tenants), "arms": list(self.arms),
                "pulls": np.asarray(self.pulls),
                "reward": np.asarray(self.reward),
                "dtype": str(self.reward.dtype)}

    @classmethod
    def from_state(cls, state: dict) -> "ArmPosterior":
        return cls(state["tenants"], state["arms"], pulls=state["pulls"],
                   reward=state["reward"],
                   dtype=np.dtype(state["dtype"]))

    def merge(self, other: "ArmPosterior") -> "ArmPosterior":
        if (self.tenants != other.tenants or self.arms != other.arms):
            raise ValueError(
                "cannot merge posteriors over different manifests")
        self.pulls = self.pulls + other.pulls
        self.reward = self.reward + other.reward.astype(self.reward.dtype)
        return self

    def apply(self, t_idx: np.ndarray, a_idx: np.ndarray,
              rewards: np.ndarray) -> None:
        """Host-side fold of one event batch (the consumer's mirror:
        integer adds, so it stays equal to the device state)."""
        np.add.at(self.pulls, (t_idx, a_idx), 1)
        np.add.at(self.reward, (t_idx, a_idx),
                  np.asarray(rewards).astype(self.reward.dtype))

    def means(self) -> np.ndarray:
        """Per-(tenant, arm) posterior mean reward (0 for untried)."""
        return self.reward / np.maximum(self.pulls, 1)

    def lines(self, delim: str = ",") -> List[str]:
        return posterior_lines(self.tenants, self.arms, self.pulls,
                               self.reward, delim)


def _pow2(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class PosteriorStore:
    """The live posterior of one tenant fleet, on one device.

    ``fold_events`` sends an event batch to the device
    (``core.pipeline.ChunkTransfer``, padded to a power-of-two row bucket
    with tenant -1, which adds nothing), folds it out of place and swaps
    the ``{"pulls", "reward"}`` state under the store's lock (folds are
    serialized by a lock of their own, so a decide waits for the swap
    only); ``decide``
    takes the state under the same lock and scores against it, so it
    sees one fold's pulls and rewards together.  ``pulls`` stay int64
    (``restore`` does not narrow them).  With a ``mesh`` of several
    positions the rows are split over the positions and the partial
    tables summed onto its first device, as the reference's fold does."""

    def __init__(self, key: str, tenants: Sequence[str],
                 arms: Sequence[str], algorithm: str = ALGO_THOMPSON,
                 seed: int = DEFAULT_SEED, sigma: float = DEFAULT_SIGMA,
                 dtype: str = DEFAULT_DTYPE, device=None, mesh=None):
        from ..core import pipeline
        from ..device import resolve_device

        if algorithm not in (ALGO_THOMPSON, ALGO_UCB):
            raise ValueError(
                f"{KEY_ALGORITHM} must be {ALGO_THOMPSON} or {ALGO_UCB}: "
                f"{algorithm!r}")
        self.key = key
        self.tenants = list(tenants)
        self.arms = list(arms)
        self.tenant_index = {t: i for i, t in enumerate(self.tenants)}
        self.arm_index = {a: i for i, a in enumerate(self.arms)}
        self.algorithm = algorithm
        self.seed = int(seed)
        self.sigma = float(sigma)
        self.dtype = _dtype_from_name(dtype)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else resolve_device(device))
        self._static = (len(self.tenants), len(self.arms), str(self.dtype))
        self._lock = sanitizer.make_lock("stream.posterior")
        self._fold_lock = sanitizer.make_lock("stream.posterior.fold")
        self._xfer = pipeline.ChunkTransfer(self.device, mesh=self.mesh)
        self._state = self._place(self._zero_state())
        self._decide_fns: dict = {}

    def _zero_state(self) -> dict:
        shape = (len(self.tenants), len(self.arms))
        return {"pulls": np.zeros(shape, np.int64),
                "reward": np.zeros(shape, self.dtype)}

    def _place(self, host: dict) -> dict:
        return {"pulls": torch.tensor(np.asarray(host["pulls"], np.int64),
                                      device=self.device),
                "reward": torch.tensor(np.asarray(host["reward"],
                                                  self.dtype),
                                       device=self.device)}

    @classmethod
    def from_config(cls, key: str, config, device=None,
                    mesh=None) -> "PosteriorStore":
        return cls(key,
                   tenants_from_config(config),
                   arms_from_config(config),
                   algorithm=config.get(KEY_ALGORITHM, ALGO_THOMPSON),
                   seed=config.get_int(KEY_SEED, DEFAULT_SEED),
                   sigma=config.get_float(KEY_SIGMA, DEFAULT_SIGMA),
                   dtype=config.get(KEY_DTYPE, DEFAULT_DTYPE),
                   device=device, mesh=mesh)

    # -- the feedback fold (consumer side) ---------------------------------
    def _fold_part(self, t_idx: np.ndarray, a_idx: np.ndarray,
                   rewards: np.ndarray, rows: int) -> dict:
        """One batch's tables on the device, padded to ``rows`` (pad rows
        carry tenant -1 and add nothing)."""
        from ..ops.counting import sharded_reduce_resident

        n = len(t_idx)
        t = np.full(rows, -1, np.int32)
        a = np.zeros(rows, np.int32)
        r = np.zeros(rows, np.int64)
        t[:n], a[:n], r[:n] = t_idx, a_idx, rewards
        *arrays, mask = self._xfer((t, a, r))
        if self.mesh is not None:
            return sharded_reduce_resident(
                _posterior_local, *arrays, mask=mask, mesh=self.mesh,
                static_args=self._static)
        return _posterior_local(*arrays, mask, *self._static)

    def fold_events(self, t_idx: np.ndarray, a_idx: np.ndarray,
                    rewards: np.ndarray) -> None:
        """Fold one parsed event batch into the device state and publish
        the new state (one assignment under the lock)."""
        from ..core.obs import get_tracer

        n = len(t_idx)
        if n == 0:
            return
        # folds run one at a time; the decide path waits only for the
        # swap, never for a transfer (a new bucket's pinned staging)
        with self._fold_lock, get_tracer().span("stream.fold",
                                                store=self.key):
            part = self._fold_part(t_idx, a_idx, rewards, _pow2(n))
            with self._lock:
                state = self._state
                self._state = {"pulls": state["pulls"] + part["pulls"],
                               "reward": state["reward"] + part["reward"]}

    def prepare_fold(self, max_rows: int) -> None:
        """Run the fold once at every row bucket up to ``max_rows`` and
        drop the result (the state does not change): a card then has the
        fold's kernels loaded and its pinned staging allocated before the
        first event, which would otherwise stall the decides beside it."""
        empty = np.zeros(0, np.int64)
        b = _pow2(1)
        while True:
            with self._fold_lock:
                part = self._fold_part(empty, empty, empty, b)
                with self._lock:
                    state = self._state
                {k: state[k] + v for k, v in part.items()}
            if b >= _pow2(max_rows):
                break
            b *= 2

    def restore(self, state: dict) -> None:
        """Seed the state from a checkpointed host posterior (resume)."""
        post = ArmPosterior.from_state(state)
        if post.tenants != self.tenants or post.arms != self.arms:
            raise ValueError(
                "checkpointed posterior manifest does not match this "
                "store's tenant/arm manifest")
        placed = self._place({"pulls": post.pulls, "reward": post.reward})
        with self._lock:
            self._state = placed

    def host_posterior(self) -> ArmPosterior:
        """The state copied to the host."""
        with self._lock:
            state = self._state
        return ArmPosterior(self.tenants, self.arms,
                            pulls=state["pulls"].cpu().numpy(),
                            reward=state["reward"].cpu().numpy(),
                            dtype=self.dtype)

    # -- the decide path (serving side) ------------------------------------
    def _decide_fn(self):
        fn = self._decide_fns.get(self.algorithm)
        if fn is None:
            seed, sigma = self.seed, self.sigma

            def ucb(pulls, reward, tid, crc):
                return _ucb_decide(pulls, reward, tid)

            def thompson(pulls, reward, tid, crc):
                return _thompson_decide(pulls, reward, tid, crc,
                                        seed, sigma)

            fn = ucb if self.algorithm == ALGO_UCB else thompson
            if self.device.type == "cuda":
                fn = GraphedCall(fn, self.device)
            fn = telemetry.profiled_build(
                fn, f"stream.decide.{self.algorithm}:{self.key}")
            self._decide_fns[self.algorithm] = fn
        return fn

    def prepare_decide(self, buckets: Sequence[int]) -> None:
        """Build the decide path at each request bucket now (on a card:
        capture its graphs), so no request pays for it."""
        for b in buckets:
            self.decide(np.zeros(b, np.int32), np.zeros(b, np.uint32))

    def decide(self, tenant_idx: np.ndarray,
               crcs: np.ndarray) -> np.ndarray:
        """Arm index per request row (rows pre-padded by the caller; pad
        rows score against tenant 0 and are discarded)."""
        with self._lock:
            state = self._state
            fn = self._decide_fn()
        tid = torch.from_numpy(np.asarray(tenant_idx, np.int64)).to(
            self.device)
        crc = torch.from_numpy(
            np.asarray(crcs, np.uint32).astype(np.int64)).to(self.device)
        return fn(state["pulls"], state["reward"], tid, crc).cpu().numpy()


# ---------------------------------------------------------------------------
# the process-local store registry (shared by replicas and the consumer)
# ---------------------------------------------------------------------------

_STORES: Dict[str, PosteriorStore] = {}
_STORES_LOCK = sanitizer.make_lock("stream.stores")


def get_store(key: str) -> Optional[PosteriorStore]:
    with _STORES_LOCK:
        return _STORES.get(key)


def register_store(store: PosteriorStore) -> PosteriorStore:
    with _STORES_LOCK:
        _STORES[store.key] = store
    return store


def _check_store_config(store: PosteriorStore, config) -> None:
    """A config resolving to an already-registered store must not
    disagree with it: every stream.* identity field the config declares
    is checked against the registered store."""
    declared = []
    if config.get(KEY_TENANTS) or config.get(KEY_TENANTS_PATH):
        declared.append(("tenants", tenants_from_config(config),
                         store.tenants))
    if config.get(KEY_ARMS):
        declared.append(("arms", arms_from_config(config), store.arms))
    if config.get(KEY_ALGORITHM):
        declared.append(("algorithm", config.get(KEY_ALGORITHM),
                         store.algorithm))
    if config.get(KEY_SEED) is not None:
        declared.append(("seed", config.get_int(KEY_SEED), store.seed))
    if config.get(KEY_DTYPE):
        declared.append(("dtype", str(_dtype_from_name(
            config.get(KEY_DTYPE))), str(store.dtype)))
    for field, want, have in declared:
        if want != have:
            raise ValueError(
                f"stream.store {store.key!r} is already registered with "
                f"{field}={have!r}, but this config declares {want!r} — "
                f"use a different {KEY_STORE} key (or restart) instead "
                f"of silently serving from the stale manifest")


def ensure_store(config, device=None, mesh=None) -> PosteriorStore:
    """The store named by ``stream.store``: the registered instance when
    one exists (every replica's adapter and the feedback consumer share
    one state; the stream.* identity fields the config declares must
    match it), else built from the config manifest on ``device`` and
    registered."""
    key = config.get(KEY_STORE, DEFAULT_STORE)
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = _STORES[key] = PosteriorStore.from_config(
                key, config, device=device, mesh=mesh)
        else:
            _check_store_config(store, config)
        return store


def clear_stores() -> None:
    """Drop every registered store (test isolation)."""
    with _STORES_LOCK:
        _STORES.clear()


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
