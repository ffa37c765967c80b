"""Exactly-once feedback consumer: Redis stream -> per-arm posterior fold.
The port of ``avenir_tpu/stream/consumer.py`` (host code, copied).

Reward events arrive as stream entries (``data`` field
``tenant,arm,reward``, optional ``trace`` field carrying the decision's
trace id) read through a consumer group — at-least-once delivery with
per-consumer pending redelivery.  Exactly-once application is built
from three pieces:

1. **One sidecar.** The last-applied entry id (the watermark) and the
   fold carry persist together in a single
   :class:`~avenir_tpu_torch.core.checkpoint.OffsetCheckpointer` payload, so
   a kill anywhere leaves a consistent (offset, carry) pair; corruption
   falls back a generation (a lower watermark just replays more pending
   entries — the integer-exact fold keeps the result byte-identical).
2. **Watermark dedup.** Each delivered batch is sorted by entry id
   (restoring order under injected reordering) and applied in id order;
   an entry at or below the watermark was already folded into the carry
   and is skipped as a duplicate (and acknowledged, since it is covered
   by a checkpoint).
3. **Ack one generation behind.** Applied entries stay UNACKNOWLEDGED
   until a checkpoint KNOWN VALID covers them.  The just-written
   sidecar is not yet known valid — the chaos model corrupts exactly
   the newest generation — so each periodic save acknowledges only up
   to the PREVIOUS save's offset (the ack horizon); a clean stop's
   final save is read back through the validating loader before its
   offset becomes the horizon.  Corrupting the newest generation then
   costs nothing: resume falls back to the previous generation, and
   every entry above that generation's offset is still pending —
   redelivered and re-applied against exactly the carry that excludes
   it.  A crash after apply but before checkpoint leaves entries
   pending above the watermark (re-applied once); after checkpoint but
   before ack, pending at or below it (deduped, acked).

Decision -> reward causality: the ``trace`` field joins a reward to the
decide request that produced it; a tenant whose cumulative regret
(best-arm posterior mean minus observed reward, floored at 0) crosses
``stream.regret.threshold`` triggers exactly one flight-recorder dump
(latched per tenant) naming the offending trace.

Fault points (``core.faultinject``): ``feedback_dup`` (a batch is
delivered twice), ``feedback_reorder`` (a batch arrives reversed),
``feedback_drop`` (the consumer dies after delivery, before apply) —
each recovery is a deterministic test (tests/test_torch_stream.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import faultinject, flight, telemetry
from ..core.checkpoint import OffsetCheckpointer
from ..core.metrics import Counters
from ..core.obs import get_tracer
from ..models.streaming import _sid
from .posterior import (ArmPosterior, PosteriorStore, STREAM_GROUP,
                        parse_event)

KEY_STREAM = "stream.feedback.stream"
KEY_GROUP = "stream.consumer.group"
KEY_CONSUMER = "stream.consumer.name"
KEY_BATCH = "stream.consumer.batch"
KEY_BLOCK_MS = "stream.consumer.block.ms"
KEY_CKPT_EVENTS = "stream.checkpoint.interval.events"
KEY_REGRET_THRESHOLD = "stream.regret.threshold"
KEY_TRIM = "stream.trim.enable"

DEFAULT_STREAM = "avenir-feedback"
DEFAULT_GROUP = "deciders"
DEFAULT_CONSUMER = "consumer-1"
DEFAULT_BATCH = 256
DEFAULT_BLOCK_MS = 50
DEFAULT_CKPT_EVENTS = 256

#: the watermark before anything was applied (below every real id)
ZERO_OFFSET = "0-0"


class FeedbackConsumer:
    """One posterior store's stream consumer (runs on the caller's
    thread; :class:`~avenir_tpu_torch.stream.service.StreamDecisionService`
    wraps it in a daemon thread)."""

    def __init__(self, config, store: PosteriorStore, transport,
                 checkpointer: Optional[OffsetCheckpointer] = None):
        self.config = config
        self.store = store
        self.transport = transport
        self.checkpointer = checkpointer
        self.batch = config.get_int(KEY_BATCH, DEFAULT_BATCH)
        self.block_ms = config.get_int(KEY_BLOCK_MS, DEFAULT_BLOCK_MS)
        self.regret_threshold = config.get_float(KEY_REGRET_THRESHOLD, 0.0)
        #: stream trimming (ROADMAP: the feedback stream otherwise grows
        #: forever): after each checkpoint's acks, XTRIM entries at or
        #: below the ack horizon — every one of them is applied, acked,
        #: AND covered by a known-valid checkpoint, so a resumed
        #: consumer never needs them again (byte-identical resume from
        #: the watermark).  The trim is
        #: clamped to the ALL-consumer-groups ack floor by the transport.
        self.trim = config.get_boolean(KEY_TRIM, False)
        self.counters = Counters()
        self.last_applied = ZERO_OFFSET
        #: the ack horizon: the offset of the newest checkpoint KNOWN
        #: VALID (previous save, validated resume load, or read-back-
        #: validated final save) — only entries at or below it are ever
        #: acknowledged, so newest-generation corruption never strands
        #: an acked-but-uncheckpointed entry
        self._ack_horizon = ZERO_OFFSET
        #: the newest save's offset (becomes the horizon at the NEXT
        #: save, once a younger sidecar shields it)
        self._last_saved = ZERO_OFFSET
        #: applied-but-unacknowledged entry ids (acked once the horizon
        #: passes them)
        self._unacked: List[str] = []
        self._since_save = 0
        self._batches = 0
        self._pending_drained = False
        #: PEL drain cursor: pending entries are walked ONCE (applied or
        #: deduped entries stay pending until their covering checkpoint
        #: acks them, so a plain re-read would loop forever)
        self._pending_cursor = ZERO_OFFSET
        self._stopped = False
        #: host mirror of the carry (integer adds — stays byte-equal to
        #: the device fold) feeding the regret monitor and gauges
        self.mirror = ArmPosterior(store.tenants, store.arms,
                                   dtype=store.dtype)
        self.regret: np.ndarray = np.zeros(len(store.tenants))
        self._regret_latched: set = set()
        if checkpointer is not None and checkpointer.resume:
            self._resume()

    # -- resume ------------------------------------------------------------
    def _resume(self) -> None:
        payload = self.checkpointer.load()
        if payload is None:
            return
        self.store.restore(payload["carry"])
        self.mirror = ArmPosterior.from_state(payload["carry"])
        self.last_applied = payload["offset"]
        # the loaded sidecar passed validation, so its offset is a
        # proven-valid horizon
        self._ack_horizon = payload["offset"]
        self._last_saved = payload["offset"]
        state = payload["state"]
        self.regret = np.asarray(state["regret"], float)
        self._regret_latched = set(state["latched"])
        for name, value in state["counters"].items():
            self.counters.set(STREAM_GROUP, name, value)

    # -- the apply path ----------------------------------------------------
    def _parse(self, fields: Dict[str, str]):
        """(tenant idx, arm idx, reward, trace id | None) or None for a
        malformed entry — the SAME validation the batch replay spec
        applies (one shared :func:`~.posterior.parse_event`)."""
        data = fields.get("data", "")
        ev = parse_event(data.split(","), 0, 1, 2,
                         self.store.tenant_index, self.store.arm_index)
        if ev is None:
            return None
        return ev[0], ev[1], ev[2], (fields.get("trace") or None)

    def _watch_regret(self, t_idx: Sequence[int], rewards: Sequence[int],
                      traces: Sequence[Optional[str]]) -> None:
        """Per-event regret accounting against the post-batch posterior
        means; a tenant crossing ``stream.regret.threshold`` triggers
        EXACTLY ONE flight dump (latched) naming the event that crossed
        it.  Monitoring surface only — NOT part of the byte-parity
        contract (redelivery may legitimately re-batch events, shifting
        which post-batch means each event is scored against)."""
        if not len(t_idx):
            return
        means = self.mirror.means()
        best = means.max(axis=1)
        for ti, r, trace in zip(t_idx, rewards, traces):
            self.regret[ti] += max(float(best[ti]) - float(r), 0.0)
            if (self.regret_threshold > 0
                    and ti not in self._regret_latched
                    and self.regret[ti] > self.regret_threshold):
                self._regret_latched.add(ti)
                self.counters.incr(STREAM_GROUP, "Regret anomalies")
                flight.trigger(
                    "regret-anomaly", trace_id=trace,
                    tenant=self.store.tenants[ti],
                    regret=round(float(self.regret[ti]), 6),
                    threshold=self.regret_threshold)
        metrics = telemetry.get_metrics()
        metrics.set_gauge("stream.regret.total", float(self.regret.sum()))
        for ti in sorted(set(int(t) for t in t_idx)):
            tenant = self.store.tenants[ti]
            for aj, arm in enumerate(self.store.arms):
                metrics.set_gauge(
                    telemetry.labeled("stream.posterior.mean",
                                      tenant=tenant, arm=arm),
                    float(means[ti, aj]))
                metrics.set_gauge(
                    telemetry.labeled("stream.posterior.pulls",
                                      tenant=tenant, arm=arm),
                    float(self.mirror.pulls[ti, aj]))

    def _apply_entries(self, entries: List[tuple],
                       redelivered: bool) -> int:
        """Sort, dedupe against the watermark, fold the fresh events,
        and advance the watermark.  Returns fresh events applied."""
        fi = faultinject.get_injector()
        if fi is not None:
            if fi.armed("feedback_dup", index=self._batches) is not None:
                entries = list(entries) + list(entries)
                self.counters.incr(STREAM_GROUP, "Injected duplicates",
                                   len(entries) // 2)
            if fi.armed("feedback_reorder",
                        index=self._batches) is not None:
                entries = list(entries)[::-1]
            # the crash-between-delivery-and-apply fault: entries stay
            # pending unacked; the resumed consumer must redeliver them
            fi.fire("feedback_drop", index=self._batches)
        self._batches += 1
        entries = sorted(entries, key=lambda e: _sid(e[0]))
        t_idx: List[int] = []
        a_idx: List[int] = []
        rewards: List[int] = []
        traces: List[Optional[str]] = []
        dup_ids: List[str] = []
        fresh_ids: List[str] = []
        watermark = _sid(self.last_applied)
        horizon = _sid(self._ack_horizon)
        for eid, fields in entries:
            if _sid(eid) <= watermark:
                # duplicate delivery: already folded into this carry —
                # skip.  Ack ONLY when a known-valid checkpoint covers
                # the id (the ack horizon); a duplicate above it is
                # already tracked in _unacked by its first copy and
                # must wait for a covering checkpoint, or a crash (or a
                # corrupted newest generation) would silently drop the
                # event.
                self.counters.incr(STREAM_GROUP, "Duplicates skipped")
                if _sid(eid) <= horizon:
                    dup_ids.append(eid)
                continue
            watermark = _sid(eid)
            self.last_applied = eid
            fresh_ids.append(eid)
            parsed = self._parse(fields)
            if parsed is None:
                self.counters.incr(STREAM_GROUP, "Malformed events")
                continue
            ti, ai, r, trace = parsed
            t_idx.append(ti)
            a_idx.append(ai)
            rewards.append(r)
            traces.append(trace)
        if dup_ids:
            self.transport.ack(dup_ids)
        if redelivered and fresh_ids:
            self.counters.incr(STREAM_GROUP, "Redelivered applied",
                               len(fresh_ids))
        if t_idx:
            ti = np.asarray(t_idx, np.int32)
            ai = np.asarray(a_idx, np.int32)
            rs = np.asarray(rewards, np.int64)
            with get_tracer().span("stream.feedback.apply",
                                   events=len(t_idx)):
                self.store.fold_events(ti, ai, rs)
            self.mirror.apply(ti, ai, rs)
            self.counters.incr(STREAM_GROUP, "Events applied", len(t_idx))
            self._watch_regret(t_idx, rewards, traces)
        self._unacked.extend(fresh_ids)
        self._since_save += len(fresh_ids)
        if (self.checkpointer is not None
                and self._since_save >= self.checkpointer.interval):
            self.checkpoint()
        return len(fresh_ids)

    # -- checkpointing -----------------------------------------------------
    def checkpoint(self, final: bool = False) -> None:
        """Persist (watermark, carry, consumer state) as ONE sidecar,
        then acknowledge up to the ack horizon — the PREVIOUS save's
        offset, now shielded by this younger generation (``final=True``
        instead reads the just-written sidecar back through the
        validating loader, so a clean stop acks everything its proven
        final checkpoint covers)."""
        if self.checkpointer is None:
            return
        state = {
            "regret": np.asarray(self.regret),
            "latched": sorted(self._regret_latched),
            "counters": dict(self.counters.as_dict().get(
                STREAM_GROUP, {})),
        }
        with get_tracer().span("stream.checkpoint",
                               offset=self.last_applied):
            self.checkpointer.save(self.last_applied,
                                   self.mirror.state_dict(), state)
        horizon = self._last_saved
        self._last_saved = self.last_applied
        self.counters.incr(STREAM_GROUP, "Checkpoints")
        if final:
            from ..core.checkpoint import CheckpointCorrupt
            try:
                payload = self.checkpointer.load()
            except CheckpointCorrupt:
                payload = None
            if payload is not None:
                horizon = payload["offset"]
        if _sid(horizon) > _sid(self._ack_horizon):
            self._ack_horizon = horizon
        cut = _sid(self._ack_horizon)
        ack = [i for i in self._unacked if _sid(i) <= cut]
        self._unacked = [i for i in self._unacked if _sid(i) > cut]
        self.transport.ack(ack)
        self._since_save = 0
        if self.trim and cut > _sid(ZERO_OFFSET):
            # everything at or below the horizon is applied + acked +
            # checkpoint-covered; the transport clamps to the slowest
            # consumer group's floor before issuing XTRIM
            removed = self.transport.trim_acked(self._ack_horizon)
            if removed:
                self.counters.incr(STREAM_GROUP, "Trimmed entries",
                                   removed)

    # -- the pull loop -----------------------------------------------------
    def step(self) -> int:
        """One read+apply cycle; returns fresh events applied.  The
        FIRST cycles after (re)start drain this consumer's pending
        entries (crash redelivery) before any new reads."""
        if not self._pending_drained:
            entries = self.transport.read_pending(
                self.batch, after=self._pending_cursor)
            if entries:
                self._pending_cursor = entries[-1][0]
                return self._apply_entries(entries, redelivered=True)
            self._pending_drained = True
        entries = self.transport.read_new(self.batch,
                                          block_ms=self.block_ms)
        if not entries:
            return 0
        return self._apply_entries(entries, redelivered=False)

    def run(self, max_events: Optional[int] = None,
            idle_timeout: Optional[float] = None,
            poll_interval: float = 0.01) -> int:
        """Pull until stopped / ``max_events`` / ``idle_timeout`` idle
        seconds (None = forever, the service loop).  A CLEAN exit (stop
        flag, event bound, idle timeout) writes a read-back-validated
        final checkpoint so the next start resumes exactly; an exception
        is a crash — no final save, the last periodic checkpoint plus
        pending redelivery carry the exactly-once contract."""
        processed = 0
        idle_since = None
        while not self._stopped and (max_events is None
                                     or processed < max_events):
            n = self.step()
            if n:
                processed += n
                idle_since = None
                continue
            if idle_timeout is not None:
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > idle_timeout:
                    break
            time.sleep(poll_interval)
        if self.checkpointer is not None and (self._unacked
                                              or self._since_save):
            self.checkpoint(final=True)
        return processed

    def stop(self) -> None:
        self._stopped = True

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        return {"counters": self.counters.as_dict().get(STREAM_GROUP, {}),
                "offset": self.last_applied,
                "unacked": len(self._unacked),
                "regret_total": float(self.regret.sum()),
                "regret_latched": [self.store.tenants[t]
                                   for t in sorted(self._regret_latched)]}


def consumer_identity(config, store: PosteriorStore) -> Dict[str, object]:
    """The declared stream identity the offset sidecar validates: a
    checkpoint from a different stream/group/manifest/dtype must never
    resume this consumer."""
    return {"stream": config.get(KEY_STREAM, DEFAULT_STREAM),
            "group": config.get(KEY_GROUP, DEFAULT_GROUP),
            "tenants": ",".join(store.tenants),
            "arms": ",".join(store.arms),
            "dtype": str(store.dtype)}


def checkpointer_from_config(config, store: PosteriorStore,
                             default_path: str
                             ) -> Optional[OffsetCheckpointer]:
    return OffsetCheckpointer.from_config(
        config, config.get_int(KEY_CKPT_EVENTS, DEFAULT_CKPT_EVENTS),
        consumer_identity(config, store), default_path)
