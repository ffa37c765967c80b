"""Streaming reinforcement learning, the Storm/Redis topology replacement:
the port of ``avenir_tpu/models/streaming.py``.

Reference surface being re-expressed (citations into the Java reference):
- ``org.avenir.reinforce.ReinforcementLearnerTopology`` — properties file ->
  Storm Config; RedisSpout(xN) shuffle-grouped to
  ReinforcementLearnerBolt(xM); StormSubmitter
  (reinforce/ReinforcementLearnerTopology.java:42-85).
- ``RedisSpout`` — ``rpop`` of ``redis.event.queue``, events are
  ``eventID,roundNum`` (reinforce/RedisSpout.java:86-100).
- ``ReinforcementLearnerBolt`` — on an event: drain the reward queue into
  ``learner.setReward``, select ``learner.nextActions()``, write
  ``eventID,action[,action...]`` to the action queue; on a reward tuple:
  apply it (reinforce/ReinforcementLearnerBolt.java:92-125); learner built
  from config keys ``reinforcement.learner.type`` /
  ``reinforcement.learrner.actions`` [sic — the reference's typo'd key is
  accepted too] (:66-71).
- ``RedisActionWriter`` / ``RedisRewardReader`` — queue adapters; rewards
  are ``actionID,reward`` lines (reinforce/RedisActionWriter.java:45-58,
  RedisRewardReader.java:53-88).

Re-design: Storm's spout/bolt thread graph existed to scale trivial per-event
math across JVM workers; a single host loop keeps up with any realistic event
rate here, so the topology becomes ``StreamingLearnerLoop`` — a pull loop
over a ``Transport`` with the same three queues and wire formats.
``InMemoryTransport`` serves tests/embedding; ``RedisTransport`` is a
drop-in for the reference's deployment (requires the optional ``redis``
package; the queue names/keys match, so the reference's producers/consumers
interoperate unchanged).

The queue transports, the stream transport and the single-learner loop
are host code, copied.  ``GroupedStreamingLearnerLoop`` steps a
``models.reinforce_vec.VectorizedLearnerGroup`` on one device (``cuda:0``
unless the caller asks for another).
"""

from __future__ import annotations

import re
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .reinforce import ReinforcementLearner, create_learner
from ..core import sanitizer
from ..core.obs import traced_run
from ..core.resilience import with_retries

_INT_RE = re.compile(r"-?\d+", re.ASCII)


class FakeRedisError(Exception):
    """The fakeredis-style stand-in for ``redis.exceptions.ResponseError``
    (``BUSYGROUP`` / ``NOGROUP`` messages match the server's, so callers
    classifying by message work against either client)."""


class Transport:
    """Queue transport: event source, reward source, action sink."""

    def next_event(self) -> Optional[str]:
        """Pop one ``eventID,roundNum`` message, or None when idle."""
        raise NotImplementedError

    def read_rewards(self) -> List[str]:
        """Drain pending ``actionID,reward`` messages."""
        raise NotImplementedError

    def write_action(self, message: str) -> None:
        """Push one ``eventID,action[,action...]`` message."""
        raise NotImplementedError


class InMemoryTransport(Transport):
    """Process-local queues (tests / embedded use).  Events live in a
    deque: the fleet loop pops tens of thousands per wave and a list's
    ``pop(0)`` is O(queue) per pop — the r4 bench spent more time
    shifting list elements than stepping learners."""

    def __init__(self):
        self.events: deque = deque()
        self.rewards: List[str] = []
        self.actions: List[str] = []

    def push_event(self, event_id: str, round_num: int) -> None:
        self.events.append(f"{event_id},{round_num}")

    def push_reward(self, action_id: str, reward: int) -> None:
        self.rewards.append(f"{action_id},{reward}")

    def next_event(self) -> Optional[str]:
        return self.events.popleft() if self.events else None

    def read_rewards(self) -> List[str]:
        out, self.rewards = self.rewards, []
        return out

    def write_action(self, message: str) -> None:
        self.actions.append(message)


def _sid(entry_id: str) -> Tuple[int, int]:
    """A stream entry id's sort key (``<ms>-<seq>`` -> (ms, seq))."""
    ms, _, seq = str(entry_id).partition("-")
    return int(ms), int(seq or 0)


#: below every real entry id (trimming to here would be a no-op)
ZERO_TRIM_ID = "0-0"


class FakeRedis:
    """fakeredis-style in-process double of the redis-py commands the
    transports use — the list commands (:class:`RedisTransport`: same
    lpush/rpop semantics and decoded-string returns) PLUS the stream
    commands (:class:`RedisStreamTransport`: XADD / XLEN / XRANGE /
    XGROUP CREATE / XREADGROUP / XACK / XPENDING with consumer groups,
    per-consumer pending-entry redelivery, and blocking reads), no
    server.  Producers/consumers standing in for the reference's Redis
    peers (and the round-trip tests in ``tests/test_reinforce.py`` /
    ``tests/test_stream.py``) drive the REAL transports against this
    client, so both wire protocols are covered without the optional
    ``redis`` dependency.

    Entry ids are deterministic (``1-0``, ``2-0``, ... per stream — the
    server's ``<ms>-<seq>`` shape with a counter clock), so tests and
    the byte-equivalence gates reproduce exactly.  Thread-safe: one
    condition guards every structure, and blocking ``xreadgroup`` reads
    wait on it."""

    def __init__(self):
        self._cond = sanitizer.make_condition("models.fakeredis")
        self._lists: Dict[str, deque] = {}
        #: stream key -> ordered [(id, fields dict)]
        self._streams: Dict[str, List[Tuple[str, Dict[str, str]]]] = {}
        self._next_id: Dict[str, int] = {}
        #: (stream, group) -> {"last": id, "pending": {id: consumer}}
        self._groups: Dict[Tuple[str, str], dict] = {}

    # -- list commands (the reference queue protocol) ----------------------
    def lpush(self, key: str, *values) -> int:
        with self._cond:
            q = self._lists.setdefault(key, deque())
            for v in values:
                q.appendleft(str(v))
            return len(q)

    def rpop(self, key: str) -> Optional[str]:
        with self._cond:
            q = self._lists.get(key)
            return q.pop() if q else None

    def llen(self, key: str) -> int:
        with self._cond:
            return len(self._lists.get(key) or ())

    def lrange(self, key: str, start: int, stop: int) -> List[str]:
        with self._cond:
            items = list(self._lists.get(key) or ())
            return items[start:None if stop == -1 else stop + 1]

    # -- stream commands (XADD / consumer groups) --------------------------
    def xadd(self, key: str, fields: Dict[str, str], id: str = "*") -> str:
        with self._cond:
            entries = self._streams.setdefault(key, [])
            if id == "*":
                n = self._next_id.get(key, 0) + 1
                self._next_id[key] = n
                eid = f"{n}-0"
            else:
                eid = str(id)
                if entries and _sid(eid) <= _sid(entries[-1][0]):
                    raise FakeRedisError(
                        "ERR The ID specified in XADD is equal or smaller "
                        "than the target stream top item")
                self._next_id[key] = max(self._next_id.get(key, 0),
                                         _sid(eid)[0])
            entries.append((eid, {str(k): str(v)
                                  for k, v in fields.items()}))
            self._cond.notify_all()
            return eid

    def xlen(self, key: str) -> int:
        with self._cond:
            return len(self._streams.get(key) or ())

    def xrange(self, key: str, min: str = "-", max: str = "+",
               count: Optional[int] = None):
        with self._cond:
            entries = list(self._streams.get(key) or ())
        lo = None if min == "-" else _sid(min)
        hi = None if max == "+" else _sid(max)
        out = [(eid, dict(f)) for eid, f in entries
               if (lo is None or _sid(eid) >= lo)
               and (hi is None or _sid(eid) <= hi)]
        return out[:count] if count is not None else out

    def xgroup_create(self, key: str, group: str, id: str = "$",
                      mkstream: bool = False) -> bool:
        with self._cond:
            if key not in self._streams:
                if not mkstream:
                    raise FakeRedisError(
                        "ERR The XGROUP subcommand requires the key to "
                        "exist (consider MKSTREAM)")
                self._streams[key] = []
            if (key, group) in self._groups:
                raise FakeRedisError(
                    "BUSYGROUP Consumer Group name already exists")
            entries = self._streams[key]
            last = (entries[-1][0] if id == "$" and entries else "0-0")
            if id not in ("$", "0"):
                last = str(id)
            self._groups[(key, group)] = {"last": last, "pending": {}}
            return True

    def _group(self, key: str, group: str) -> dict:
        g = self._groups.get((key, group))
        if g is None:
            raise FakeRedisError(
                f"NOGROUP No such consumer group '{group}' for key name "
                f"'{key}'")
        return g

    def xreadgroup(self, groupname: str, consumername: str,
                   streams: Dict[str, str], count: Optional[int] = None,
                   block: Optional[int] = None):
        """One stream per call (all this double's users read one); id
        ``>`` delivers NEW entries (recorded pending under this
        consumer, blocking up to ``block`` ms when none), any other id
        replays THIS consumer's pending entries above it (the
        crash-redelivery path) without blocking."""
        (key, from_id), = streams.items()
        deadline = (time.monotonic() + block / 1000.0
                    if block is not None else None)
        while True:
            with self._cond:
                g = self._group(key, groupname)
                entries = self._streams.get(key) or []
                if from_id == ">":
                    lo = _sid(g["last"])
                    fresh = [(eid, dict(f)) for eid, f in entries
                             if _sid(eid) > lo]
                    if count is not None:
                        fresh = fresh[:count]
                    if fresh:
                        for eid, _ in fresh:
                            g["pending"][eid] = consumername
                        g["last"] = fresh[-1][0]
                        return [[key, fresh]]
                else:
                    lo = _sid(from_id)
                    mine = sorted(
                        (eid for eid, owner in g["pending"].items()
                         if owner == consumername and _sid(eid) > lo),
                        key=_sid)
                    if count is not None:
                        mine = mine[:count]
                    by_id = dict(entries)
                    return ([[key, [(eid, dict(by_id[eid]))
                                    for eid in mine if eid in by_id]]]
                            if mine else [])
                if deadline is None:
                    return []
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)

    def xack(self, key: str, group: str, *ids) -> int:
        with self._cond:
            g = self._group(key, group)
            n = 0
            for eid in ids:
                if g["pending"].pop(str(eid), None) is not None:
                    n += 1
            return n

    def xpending(self, key: str, group: str) -> dict:
        with self._cond:
            g = self._group(key, group)
            pend = sorted(g["pending"], key=_sid)
            return {"pending": len(pend),
                    "min": pend[0] if pend else None,
                    "max": pend[-1] if pend else None}

    def xtrim(self, key: str, maxlen: Optional[int] = None,
              minid: Optional[str] = None) -> int:
        """XTRIM: drop entries below ``minid`` (exclusive, the server's
        MINID strategy) or beyond ``maxlen`` newest; returns entries
        removed.  Deliberately DUMB, like the server command — computing
        a safe horizon across consumer groups is the caller's job
        (``RedisStreamTransport.trim_acked``)."""
        if (maxlen is None) == (minid is None):
            raise FakeRedisError(
                "ERR XTRIM requires exactly one of maxlen / minid")
        with self._cond:
            entries = self._streams.get(key)
            if not entries:
                return 0
            if minid is not None:
                cut = _sid(str(minid))
                keep = [e for e in entries if _sid(e[0]) >= cut]
            else:
                keep = entries[len(entries) - min(maxlen, len(entries)):]
            removed = len(entries) - len(keep)
            self._streams[key] = keep
            return removed

    def xinfo_groups(self, key: str) -> List[dict]:
        """XINFO GROUPS: per-group name / last-delivered-id / pending
        count (the subset the trim-horizon computation reads)."""
        with self._cond:
            if key not in self._streams:
                raise FakeRedisError("ERR no such key")
            out = []
            for (k, group), g in sorted(self._groups.items()):
                if k != key:
                    continue
                out.append({"name": group,
                            "last-delivered-id": g["last"],
                            "pending": len(g["pending"])})
            return out

    def advance_id_clock(self, key: str, ms: int) -> None:
        """Advance the stream's id counter to at least ``ms``.  A real
        server's entry ids are millisecond-clock based and therefore
        monotonic across process restarts; this double's counter clock
        restarts at 1, so a consumer resuming an offset checkpoint
        against a FRESH in-process broker calls this with its watermark
        — otherwise every new entry would sort below the watermark and
        be deduplicated away."""
        with self._cond:
            self._next_id[key] = max(self._next_id.get(key, 0), int(ms))


def _redis_client(host: str, port: int, client=None):
    """The injected client (e.g. :class:`FakeRedis`) or a real redis-py
    connection.  Construction itself is lazy on the redis side (redis-py
    connects per command), so the transient-failure surface is the
    commands — each wrapped in ``with_retries`` at its call site."""
    if client is not None:
        return client
    import redis  # optional dependency; gate at construction
    return redis.Redis(host=host, port=port, decode_responses=True)


class RedisTransport(Transport):
    """Redis-list transport matching the reference's queue protocol
    (``rpop`` events, reward list, ``lpush`` actions).  ``client``
    injects a ready client (e.g. :class:`FakeRedis`); otherwise the
    optional ``redis`` package connects to ``host:port``.  Every network
    command runs under ``core.resilience.with_retries`` (transient
    ``OSError``-family failures back off and reattempt; the io-retry
    analysis rule patrols these call sites)."""

    def __init__(self, host: str, port: int, event_queue: str,
                 reward_queue: str, action_queue: str, client=None):
        self._r = _redis_client(host, port, client)
        self.event_queue = event_queue
        self.reward_queue = reward_queue
        self.action_queue = action_queue

    def next_event(self) -> Optional[str]:
        return with_retries(lambda: self._r.rpop(self.event_queue),
                            op="redis")

    def read_rewards(self) -> List[str]:
        out = []
        while True:
            msg = with_retries(lambda: self._r.rpop(self.reward_queue),
                               op="redis")
            if msg is None:
                return out
            out.append(msg)

    def write_action(self, message: str) -> None:
        with_retries(lambda: self._r.lpush(self.action_queue, message),
                     op="redis")


class RedisStreamTransport:
    """Redis-STREAM transport for the ``stream`` feedback
    subsystem: reward events are stream entries consumed through a
    consumer group (XREADGROUP), so at-least-once delivery with
    per-consumer pending-entry redelivery is the substrate the
    exactly-once checkpoint layer rides on.  ``client`` injects a ready
    client (:class:`FakeRedis` in tests and server-less deployments);
    otherwise the optional ``redis`` package connects to ``host:port``.
    Every network command runs under ``core.resilience.with_retries``."""

    def __init__(self, host: str, port: int, stream: str, group: str,
                 consumer: str, client=None):
        self._r = _redis_client(host, port, client)
        self.stream = stream
        self.group = group
        self.consumer = consumer

    def ensure_group(self) -> None:
        """Create the consumer group from the stream head (idempotent:
        an existing group is fine — BUSYGROUP is the already-exists
        signal, not an error)."""
        try:
            with_retries(
                lambda: self._r.xgroup_create(self.stream, self.group,
                                              id="0", mkstream=True),
                op="redis")
        except Exception as e:                      # noqa: BLE001
            if "BUSYGROUP" not in str(e):
                raise

    def publish(self, fields: Dict[str, str]) -> str:
        """XADD one reward event; returns the assigned entry id."""
        return with_retries(lambda: self._r.xadd(self.stream, fields),
                            op="redis")

    def read_new(self, count: int,
                 block_ms: Optional[int] = None) -> List[tuple]:
        """XREADGROUP ``>``: up to ``count`` new entries (recorded in
        this consumer's pending list), blocking up to ``block_ms``."""
        res = with_retries(
            lambda: self._r.xreadgroup(self.group, self.consumer,
                                       {self.stream: ">"}, count=count,
                                       block=block_ms),
            op="redis")
        return list(res[0][1]) if res else []

    def read_pending(self, count: int,
                     after: str = "0-0") -> List[tuple]:
        """XREADGROUP from an explicit id: THIS consumer's still-pending
        (delivered but unacknowledged) entries above ``after`` — the
        crash-redelivery read a resumed consumer drains, cursor-style,
        before any new entries (applied-but-unacked entries stay in the
        PEL until their covering checkpoint, so the cursor is what keeps
        the drain a single pass)."""
        res = with_retries(
            lambda: self._r.xreadgroup(self.group, self.consumer,
                                       {self.stream: after}, count=count),
            op="redis")
        return list(res[0][1]) if res else []

    def ack(self, ids: Sequence[str]) -> int:
        if not ids:
            return 0
        return with_retries(
            lambda: self._r.xack(self.stream, self.group, *ids),
            op="redis")

    def pending_count(self) -> int:
        return int(with_retries(
            lambda: self._r.xpending(self.stream, self.group),
            op="redis")["pending"])

    def length(self) -> int:
        return int(with_retries(lambda: self._r.xlen(self.stream),
                                op="redis"))

    # -- trimming (ROADMAP: streams grow forever without it) ---------------
    @staticmethod
    def _next_id(eid: str) -> str:
        ms, seq = _sid(eid)
        return f"{ms}-{seq + 1}"

    def all_groups_ack_floor(self) -> Optional[str]:
        """The smallest entry id ANY consumer group of this stream still
        needs: per group, the oldest pending (delivered, unacked) entry
        when one exists, else the first id past its last-delivered
        cursor (undelivered entries must survive).  Entries BELOW the
        minimum across groups are acked by every consumer — safe to
        trim.  None when the stream has no groups (nothing is provably
        consumed, so nothing trims)."""
        groups = with_retries(lambda: self._r.xinfo_groups(self.stream),
                              op="redis")
        floors = []
        for g in groups:
            name = g.get("name")
            oldest = None
            if int(g.get("pending", 0)) > 0:
                p = with_retries(
                    lambda n=name: self._r.xpending(self.stream, n),
                    op="redis")
                # the group may have acked its last pending entry
                # between the xinfo read and this call: min comes back
                # None and the last-delivered fallback below applies
                oldest = p.get("min")
            if oldest is not None:
                floors.append(str(oldest))
            else:
                floors.append(self._next_id(
                    str(g.get("last-delivered-id", "0-0"))))
        if not floors:
            return None
        return min(floors, key=_sid)

    def trim_acked(self, horizon: str) -> int:
        """XTRIM entries at or below ``horizon`` (a checkpoint-covered
        ack horizon), clamped to the ALL-consumers ack floor so no
        group's undelivered or still-pending entries are ever dropped;
        returns entries removed."""
        floor = self.all_groups_ack_floor()
        if floor is None:
            return 0
        cut = min(self._next_id(horizon), floor, key=_sid)
        if _sid(cut) <= _sid(ZERO_TRIM_ID):
            return 0
        return int(with_retries(
            lambda: self._r.xtrim(self.stream, minid=cut), op="redis"))


def _get(config: Dict, *keys, default=None, required=False):
    """First non-None value among alternate key spellings (both dict and
    JobConfig expose .get)."""
    for k in keys:
        v = config.get(k)
        if v is not None:
            return v
    if required:
        raise ValueError(f"missing required config: {keys[0]}")
    return default


def _parse_learner_spec(config: Dict):
    """(learner type, action-id list) from the topology config keys,
    accepting the reference's typo'd actions key
    (ReinforcementLearnerBolt.java:66-71)."""
    learner_type = _get(config, "reinforcement.learner.type", required=True)
    actions = _get(config, "reinforcement.learner.actions",
                   "reinforcement.learrner.actions", required=True)
    if isinstance(actions, str):
        actions = actions.split(",")
    return learner_type, actions


def _pull_loop(step_fn, max_events: Optional[int],
               idle_timeout: Optional[float],
               poll_interval: float) -> int:
    """Shared pull-loop skeleton: ``step_fn(room)`` does up to ``room``
    events (None = unbounded) and returns how many it processed; the loop
    stops after ``max_events`` or ``idle_timeout`` idle seconds."""
    processed = 0
    idle_since = None
    while max_events is None or processed < max_events:
        room = None if max_events is None else max_events - processed
        n = step_fn(room)
        if n:
            processed += n
            idle_since = None
        else:
            if idle_timeout is None:
                time.sleep(poll_interval)
                continue
            if idle_since is None:
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since > idle_timeout:
                break
            time.sleep(poll_interval)
    return processed


class StreamingLearnerLoop:
    """The topology+bolt equivalent: one learner, three queues, a pull loop.

    ``step()`` processes at most one event (plus any pending rewards) and
    returns whether it did work; ``run()`` loops until ``max_events`` or an
    idle timeout — the Storm topology ran forever, so both bounds are
    optional.
    """

    def __init__(self, config: Dict, transport: Optional[Transport] = None):
        self.config = config
        learner_type, actions = _parse_learner_spec(config)
        self.learner: ReinforcementLearner = create_learner(
            learner_type, actions, config)
        if transport is not None:
            self.transport = transport
        else:
            writer = _get(config, "reinforcement.learner.action.writer",
                          "reinforcement.learrner.action.writer",
                          default="redis")
            if writer != "redis":
                raise ValueError(f"unknown action writer: {writer}")
            self.transport = RedisTransport(
                host=_get(config, "redis.server.host", required=True),
                port=int(_get(config, "redis.server.port", required=True)),
                event_queue=_get(config, "redis.event.queue", required=True),
                reward_queue=_get(config, "redis.reward.queue", required=True),
                action_queue=_get(config, "redis.action.queue", required=True))
        self.event_count = 0
        self.reward_count = 0

    def apply_rewards(self) -> int:
        """Drain the reward queue into the learner
        (ReinforcementLearnerBolt.java:96-99)."""
        n = 0
        for msg in self.transport.read_rewards():
            action_id, reward = msg.split(",")[:2]
            self.learner.set_reward(action_id, int(reward))
            n += 1
        self.reward_count += n
        return n

    def step(self) -> bool:
        """One spout+bolt cycle: rewards first, then one event -> actions."""
        self.apply_rewards()
        msg = self.transport.next_event()
        if msg is None:
            return False
        event_id = msg.split(",")[0]
        actions = self.learner.next_actions()
        action_list = ",".join(a.id for a in actions)
        self.transport.write_action(f"{event_id},{action_list}")
        self.event_count += 1
        return True

    @traced_run
    def run(self, max_events: Optional[int] = None,
            idle_timeout: Optional[float] = 1.0,
            poll_interval: float = 0.01) -> int:
        """Pull loop; returns events processed.  Stops after ``max_events``
        or after ``idle_timeout`` seconds with an empty event queue."""
        return _pull_loop(lambda room: int(self.step()), max_events,
                          idle_timeout, poll_interval)


class GroupedStreamingLearnerLoop:
    """Fleet-scale streaming RL: one learner PER ENTITY, batched on device.

    The reference pairs its Storm bolt with a ``ReinforcementLearnerGroup``
    (one learner per entity id, ReinforcementLearnerGroup.java:30-70); with
    thousands of entities the per-event Python map is the bottleneck SURVEY
    §7.2 stage 7 flags.  This loop drains the event queue in waves and
    advances every touched entity's learner in one masked step of a
    ``VectorizedLearnerGroup``, applying drained rewards as one bulk
    scatter.  Unknown entities auto-enroll with fresh learner state.

    Wire formats extend the single-learner loop's with the entity key:
    events ``entityID,roundNum`` (the entity IS the learner id), rewards
    ``entityID,actionID,reward``, actions out ``entityID,action``.
    """

    def __init__(self, config: Dict, transport: Transport,
                 entities: Sequence[str] = (), device=None):
        from .reinforce_vec import VectorizedLearnerGroup

        learner_type, actions = _parse_learner_spec(config)
        self.group = VectorizedLearnerGroup(learner_type, list(entities),
                                            actions, config, device=device)
        self._actions = set(actions)
        self.transport = transport
        self.event_count = 0
        self.reward_count = 0
        self.malformed_count = 0
        # action-latency knob: how many dispatched waves may backlog
        # before their selections are read back and emitted.  1 restores
        # the reference bolt's immediate per-wave emit
        # (ReinforcementLearnerBolt.java:103-117) for latency-sensitive
        # transports; the default keeps the throughput pipelining.
        pending = _get(config, "streaming.max.pending.batches")
        if pending is not None:
            pending = int(pending)
            if pending < 1:
                raise ValueError(
                    f"streaming.max.pending.batches must be >= 1: {pending}")
            self.max_pending_batches = pending

    def _parse_rewards(self):
        """Drain and validate ``entityID,actionID,reward`` messages;
        malformed or unknown-action messages are counted and skipped so
        one bad queue entry cannot take down the fleet loop."""
        gids, aids, rs = [], [], []
        for msg in self.transport.read_rewards():
            parts = msg.split(",")
            # strict integer syntax: int() alone would admit '1_0'/' 10'/+
            if (len(parts) < 3 or parts[1] not in self._actions
                    or not _INT_RE.fullmatch(parts[2])):
                self.malformed_count += 1
                continue
            gids.append(parts[0])
            aids.append(parts[1])
            rs.append(int(parts[2]))
        self.reward_count += len(gids)
        return gids, aids, rs

    def apply_rewards(self) -> int:
        """Drain the reward queue into the fleet as one bulk scatter."""
        gids, aids, rs = self._parse_rewards()
        if gids:
            self.group.add_groups(gids)
            self.group.set_rewards(gids, aids, rs)
        return len(gids)

    def _dispatch_batch(self, max_events: int):
        """Drain up to ``max_events`` events, apply pending rewards, and
        dispatch the masked device step(s) WITHOUT materializing the
        selections: returns ``(n_events, pending)`` where pending holds
        ``(wave_entities, rows, sels_device)`` records for ``_emit``.
        The async dispatch is what lets ``run()`` overlap the next
        wave's transport drain/parse with this wave's device step (the
        ``models/bayesian._train_streamed`` double-buffer pattern)."""
        entities: List[str] = []
        for _ in range(max_events):
            msg = self.transport.next_event()
            if msg is None:
                break
            # validate symmetrically with apply_rewards: a malformed or
            # empty event must not auto-enroll a bogus entity (e.g. "")
            ent = msg.split(",")[0]
            if not ent:
                self.malformed_count += 1
                continue
            entities.append(ent)
        # rewards AFTER the event drain (a transport refilled mid-drain
        # delivers this wave's rewards in time) but BEFORE the step
        # dispatch — the bolt's rewards-before-selection order
        # (ReinforcementLearnerBolt.java:92-99)
        gids, aids, rs = self._parse_rewards()
        if not entities:
            if gids:
                self.group.add_groups(gids)
                self.group.set_rewards(gids, aids, rs)
            return 0, []
        self.group.add_groups(entities)
        if gids:
            self.group.add_groups(gids)
        out = []
        todo = entities
        first = True
        while todo:
            wave: List[str] = []
            seen = set()
            rest: List[str] = []
            for e in todo:
                (rest if e in seen else wave).append(e)
                seen.add(e)
            rows = self.group.rows_for(wave)
            # batch.size selections per event in one masked scan, matching
            # the scalar loop's learner.next_actions() / the bolt's
            # eventID,action[,action...] format.  Wave inputs (reward
            # triples + active rows) go as one packed int32 array, in
            # the reference's layout (power-of-two buckets).  The first
            # sub-wave carries the drained rewards; duplicate-entity
            # sub-waves go reward-free.
            nr = len(gids) if first else 0
            rb = 8
            while rb < nr:
                rb *= 2
            wb = 8
            while wb < len(wave):
                wb *= 2
            packed = np.full(2 + 3 * rb + wb, self.group.capacity,
                             np.int32)     # pad rows = capacity (dropped)
            packed[0], packed[1] = nr, len(wave)
            packed[2:2 + 3 * rb] = 0
            if nr:
                packed[2:2 + nr] = self.group.rows_for(gids)
                packed[2 + rb:2 + rb + nr] = [
                    self.group._aindex[x] for x in aids]
                packed[2 + 2 * rb:2 + 2 * rb + nr] = rs
            packed[2 + 3 * rb:2 + 3 * rb + len(wave)] = rows
            sels = self.group.step_waved_async(packed, rb,
                                               self.group.batch_size)
            first = False
            out.append((wave, rows, sels))
            todo = rest
        self.event_count += len(entities)
        return len(entities), out

    def _emit(self, pending) -> None:
        """Copy the device selections to the host and write the
        ``entityID,action[,action...]`` messages.  All pending waves'
        selections are concatenated on the device first, so the batch
        costs one copy per distinct width (an auto-enroll between
        pipelined waves grows the fleet's state tensors)."""
        if not pending:
            return
        names = np.asarray(self.group.action_ids, dtype=object)
        mats: List = [None] * len(pending)
        by_shape: Dict[tuple, List[int]] = {}
        for i, (_, _, s) in enumerate(pending):
            by_shape.setdefault(tuple(s.shape), []).append(i)
        for shape, idxs in by_shape.items():
            flat = torch.cat([pending[i][2] for i in idxs]).cpu().numpy()
            ns = shape[0]
            for j, i in enumerate(idxs):
                mats[i] = flat[j * ns:(j + 1) * ns]
        for (wave, rows, _), sels in zip(pending, mats):
            acts = names[sels[:, rows]]                   # [n_steps, W]
            if acts.shape[0] == 1:
                for e, a in zip(wave, acts[0]):
                    self.transport.write_action(f"{e},{a}")
            else:
                for i, e in enumerate(wave):
                    self.transport.write_action(
                        e + "," + ",".join(acts[:, i]))

    def step_batch(self, max_events: int = 1024) -> int:
        """Drain rewards + up to ``max_events`` events and write their
        actions before returning (the synchronous surface; ``run()``
        pipelines batches instead).  Entities repeating within a batch
        step their learner once per event, preserving per-event
        semantics."""
        n, pending = self._dispatch_batch(max_events)
        self._emit(pending)
        return n

    # dispatched batches whose selections are still device tensors;
    # bounding the backlog bounds action latency while amortizing the
    # blocking device-to-host copy across waves.
    # Class default; ``streaming.max.pending.batches`` overrides per
    # instance (1 = the reference bolt's immediate per-wave emit).
    MAX_PENDING_BATCHES = 4

    @property
    def max_pending_batches(self) -> int:
        return getattr(self, "_max_pending_batches", self.MAX_PENDING_BATCHES)

    @max_pending_batches.setter
    def max_pending_batches(self, value: int) -> None:
        self._max_pending_batches = value

    @traced_run
    def run(self, max_events: Optional[int] = None,
            idle_timeout: Optional[float] = 1.0,
            poll_interval: float = 0.01, batch: int = 1024) -> int:
        """Pipelined pull loop: subsequent waves' drain/parse/dispatch
        run while earlier device steps are still in flight; actions are
        emitted (the blocking device read) once ``max_pending_batches``
        waves are queued (``streaming.max.pending.batches``; 1 = the
        reference bolt's immediate per-wave emit), on idle, and before
        returning — so the queue drains at dispatch speed and every
        action is flushed by exit."""
        processed = 0
        idle_since = None
        prev: List = []
        try:
            while max_events is None or processed < max_events:
                room = (batch if max_events is None
                        else min(batch, max_events - processed))
                n, pending = self._dispatch_batch(room)
                if n:
                    processed += n
                    prev.extend(pending)
                    if len(prev) >= self.max_pending_batches:
                        self._emit(prev)
                        prev = []
                    idle_since = None
                    continue
                if prev:                   # idle: flush before sleeping
                    self._emit(prev)
                    prev = []
                if idle_timeout is None:
                    time.sleep(poll_interval)
                    continue
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > idle_timeout:
                    break
                time.sleep(poll_interval)
        finally:
            self._emit(prev)
        return processed


class ReinforcementLearnerTopology:
    """CLI-shaped alias mirroring the reference entry point
    (``java -jar uber-avenir.jar <topologyName> <configFile>``,
    ReinforcementLearnerTopology.java:42-85).

    Registered in the CLI job table so
    ``python -m avenir_tpu_torch ReinforcementLearnerTopology <topologyName>
    <configFile>`` submits the streaming loop the way ``StormSubmitter``
    submitted the topology.  The two positional args keep the reference's
    order; properties may equivalently come via ``-Dconf.path``.  The loop
    runs until the event queue stays idle for ``topology.idle.timeout.sec``
    (default 1.0; the Storm topology ran forever — pass ``none`` to match)
    or ``topology.max.events`` is reached.
    """

    def __init__(self, config: Optional[Dict] = None, device=None):
        # the loop's learner is host code (models.reinforce), as in the
        # reference; ``device`` is the job driver's argument, unused
        self.config = dict(getattr(config, "props", config) or {})

    @staticmethod
    def build(config: Dict,
              transport: Optional[Transport] = None) -> StreamingLearnerLoop:
        return StreamingLearnerLoop(config, transport)

    @traced_run
    def run(self, topology_name: str, config_file: str,
            transport: Optional[Transport] = None):
        """Job-driver surface: args mirror the reference main()'s
        ``(topologyName, configFile)``; returns event/reward Counters."""
        from ..core.config import parse_properties
        from ..core.metrics import Counters

        props: Dict[str, str] = {}
        if config_file:
            with open(config_file, "r") as fh:
                props.update(parse_properties(fh.read()))
        # -D defines (and -Dconf.path contents) overlay the positional file,
        # matching load_job_config precedence (core/config.py:154-165)
        props.update(self.config)
        loop = StreamingLearnerLoop(props, transport)

        max_events = _get(props, "topology.max.events")
        idle = _get(props, "topology.idle.timeout.sec", default="1.0")
        idle_timeout = None if str(idle).lower() == "none" else float(idle)
        loop.run(max_events=int(max_events) if max_events else None,
                 idle_timeout=idle_timeout)

        counters = Counters()
        counters.incr("Topology", "EventsProcessed", loop.event_count)
        counters.incr("Topology", "RewardsApplied", loop.reward_count)
        return counters
