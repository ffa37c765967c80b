"""Rolling-window SLO monitors: per-model p50/p99/shed/error rates vs
declared targets.

Clipper and INFaaS (PAPERS.md) both treat per-variant latency tracking
as the input to every serving decision; the SLO-aware
variant router needs a rolling per-model p99-vs-SLO signal before it can
route anything.  This module computes that signal WITHOUT touching the
request hot path: every batcher already records cumulative state (the
mergeable e2e latency histogram + the ``Serve`` counters), so a monitor
sample is just a cumulative snapshot, and a rolling window is the DIFF
of two snapshots — histogram bucket counts and counters subtract exactly
the way they merge.

Per evaluation (driven by the serve telemetry exporter's tick and by
``health``/``metrics`` requests):

- window p50/p99 from the diffed bucket counts
  (``core.obs.quantile_from_counts``),
- shed rate and error rate from the diffed counters,
- violation = windowed p99 above ``serve.slo.p99.ms`` or windowed error
  rate above ``serve.slo.error.pct`` (each checked only when declared),
- ``serve.slo.degrade.evals`` CONSECUTIVE violating evaluations feed
  the model's :class:`~avenir_tpu_torch.serve.breaker.CircuitBreaker` as a
  soft-degrade signal: requests keep flowing, but ``health`` drops the
  model into ``degraded`` and the breaker-state surface says why.
  Streak advances are time-gated to one per ``window_sec / 10``, so an
  external health poller's request rate cannot accelerate the signal.

Config surface (serve.properties; README "Telemetry & SLOs"):

- ``serve.slo.p99.ms``        — declared p99 latency target (0/absent =
  latency SLO not evaluated); per-model override
  ``serve.model.<name>.slo.p99.ms``
- ``serve.slo.error.pct``     — declared max windowed error percentage;
  per-model override ``serve.model.<name>.slo.error.pct``
- ``serve.slo.window.sec``    — rolling evaluation window (default 30)
- ``serve.slo.degrade.evals`` — consecutive violating evaluations before
  the soft-degrade signal fires (default 3; 0 disables the feed)
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Mapping, Optional

from ..core import flight, sanitizer
from ..core.obs import LatencyHistogram, quantile_from_counts

KEY_P99_MS = "serve.slo.p99.ms"
KEY_ERROR_PCT = "serve.slo.error.pct"
KEY_WINDOW_SEC = "serve.slo.window.sec"
KEY_DEGRADE_EVALS = "serve.slo.degrade.evals"

DEFAULT_WINDOW_SEC = 30.0
DEFAULT_DEGRADE_EVALS = 3

SERVE_GROUP = "Serve"


class _Sample:
    """One cumulative snapshot of a batcher's lifetime state."""

    __slots__ = ("t", "counts", "n", "total", "requests", "shed",
                 "failed", "expired")

    def __init__(self, t, counts, n, total, requests, shed, failed, expired):
        self.t = t
        self.counts = counts
        self.n = n
        self.total = total
        self.requests = requests
        self.shed = shed
        self.failed = failed
        self.expired = expired


class ModelSLO:
    """One model's rolling-window monitor (thread-safe: the telemetry
    tick and request-thread ``health`` calls both observe)."""

    def __init__(self, name: str, p99_ms: float = 0.0,
                 error_pct: float = 0.0,
                 window_sec: float = DEFAULT_WINDOW_SEC,
                 degrade_evals: int = DEFAULT_DEGRADE_EVALS):
        self.name = name
        self.p99_ms = float(p99_ms)
        self.error_pct = float(error_pct)
        self.window_sec = float(window_sec)
        self.degrade_evals = int(degrade_evals)
        # streak advances are TIME-GATED: health/metrics requests also
        # evaluate, so without a minimum spacing an external poller
        # hammering `health` would turn "degrade_evals consecutive
        # evaluations" into milliseconds.  One violating evaluation per
        # window-tenth may advance the streak; sustained therefore needs
        # >= (degrade_evals - 1) * window_sec/10 of persistent violation
        # no matter how fast anyone polls.
        self.streak_spacing = self.window_sec / 10.0
        self._streak_advanced_at: Optional[float] = None
        self._hist_id: Optional[int] = None
        self._samples: deque = deque()
        self._lock = sanitizer.make_lock("serve.slo.monitor")
        self.consecutive = 0
        self.last: Dict[str, object] = self._empty()

    def _empty(self) -> dict:
        return {"n": 0, "p50_ms": None, "p99_ms": None,
                "shed_pct": 0.0, "error_pct": 0.0,
                "violation": False, "sustained": False,
                "window_sec": self.window_sec,
                "target_p99_ms": self.p99_ms or None,
                "target_error_pct": self.error_pct or None}

    def observe(self, batcher, now: Optional[float] = None) -> dict:
        """Snapshot the batcher's cumulative state, evaluate the rolling
        window, and return the window stats (also kept as ``last``)."""
        now = time.monotonic() if now is None else float(now)
        hist = batcher.e2e_hist
        counts, n, total, _vmin, _vmax = hist._state()
        c = batcher.counters
        cur = _Sample(now, counts, n, total,
                      c.get(SERVE_GROUP, "Requests"),
                      c.get(SERVE_GROUP, "Shed"),
                      c.get(SERVE_GROUP, "Failed requests"),
                      c.get(SERVE_GROUP, "Deadline expired"))
        with self._lock:
            if self._samples and (
                    id(hist) != self._hist_id
                    or cur.n < self._samples[-1].n
                    or cur.requests < self._samples[-1].requests):
                # a hot-swap reload replaced the batcher (and its
                # histogram): restart the window.  The identity check
                # matters — a busy replacement can OVERTAKE the old
                # batcher's cumulative counts within one window, and
                # diffing across two different histograms would produce
                # negative bucket deltas and a garbage windowed p99.
                self._samples.clear()
                self.consecutive = 0
                self._streak_advanced_at = None
            self._hist_id = id(hist)
            if not self._samples:
                # zero base: the first window covers everything since
                # startup (or reload) until window_sec of samples exist
                self._samples.append(_Sample(
                    now, [0] * len(cur.counts), 0, 0.0, 0, 0, 0, 0))
            self._samples.append(cur)
            while (len(self._samples) >= 2
                   and now - self._samples[1].t >= self.window_sec):
                self._samples.popleft()
            # memory bound under a hammering health poller: past 512
            # samples the window's base moves forward (each sample holds
            # a full bucket-counts list — never let that grow unbounded)
            while len(self._samples) > 512:
                self._samples.popleft()
            base = self._samples[0]
            stats = self._evaluate(base, cur, batcher.e2e_hist.bounds, now)
            self.last = stats
            return stats

    def _evaluate(self, base: _Sample, cur: _Sample, bounds,
                  now: float) -> dict:
        stats = self._empty()
        dn = cur.n - base.n
        if dn > 0:
            dcounts = [c - b for c, b in zip(cur.counts, base.counts)]
            p50 = quantile_from_counts(bounds, dcounts, 0.50)
            p99 = quantile_from_counts(bounds, dcounts, 0.99)
            stats["n"] = dn
            stats["p50_ms"] = round(p50 * 1000.0, 3) if p50 else None
            stats["p99_ms"] = round(p99 * 1000.0, 3) if p99 else None
        dreq = cur.requests - base.requests
        dshed = cur.shed - base.shed
        derr = (cur.failed - base.failed) + (cur.expired - base.expired)
        dexp = cur.expired - base.expired
        offered = dreq + dexp + dshed
        completed = dreq + dexp
        stats["shed_pct"] = round(100.0 * dshed / offered, 3) if offered else 0.0
        stats["error_pct"] = (round(100.0 * derr / completed, 3)
                              if completed else 0.0)
        violation = False
        if self.p99_ms > 0 and stats["p99_ms"] is not None:
            violation |= stats["p99_ms"] > self.p99_ms
        if self.error_pct > 0 and completed:
            violation |= stats["error_pct"] > self.error_pct
        if violation:
            at = self._streak_advanced_at
            if at is None or now - at >= self.streak_spacing:
                self.consecutive += 1
                self._streak_advanced_at = now
        else:
            self.consecutive = 0
            self._streak_advanced_at = None
        stats["violation"] = violation
        stats["sustained"] = (self.degrade_evals > 0
                              and self.consecutive >= self.degrade_evals)
        return stats


class _SnapshotCounters:
    """``Counters.get``-shaped view over plain snapshot counter dicts."""

    def __init__(self):
        self.groups: Dict[str, Dict[str, int]] = {}

    def get(self, group: str, name: str) -> int:
        return int(self.groups.get(group, {}).get(name, 0))


class SnapshotStats:
    """A batcher-shaped facade over MERGED telemetry snapshot state —
    the fleet-SLO seam.  :meth:`ModelSLO.observe` needs only three
    things from its ``batcher``: ``e2e_hist`` (a stable-identity
    :class:`LatencyHistogram`), ``counters.get(group, name)``, and
    ``breaker`` (None here: a fleet monitor evaluates windows, it has
    no single process's breaker to degrade).  The fleet aggregator
    (``fleetobs.aggregate``) keeps ONE facade per monitored model and
    loads each fresh merged cumulative state into the SAME histogram
    object — ``ModelSLO`` keys its rolling window on ``id(hist)``, so
    replacing the object per scrape would restart the window on every
    evaluation and the diffed p99 would never see more than one sample.
    """

    breaker = None

    def __init__(self):
        self.e2e_hist = LatencyHistogram()
        self.counters = _SnapshotCounters()

    def update(self, hist_state: Optional[dict],
               serve_counters: Optional[Mapping[str, int]] = None
               ) -> "SnapshotStats":
        """Load one merged cumulative state (a ``state_dict``-form
        histogram + the model's ``Serve`` counter dict) in place."""
        if hist_state is not None:
            fresh = LatencyHistogram.from_state(hist_state)
            if fresh.bounds != self.e2e_hist.bounds:
                # a bucket-ladder change is a genuine discontinuity:
                # swap the object and let the monitor restart its window
                self.e2e_hist = fresh
            else:
                h = self.e2e_hist
                with h._lock:
                    h.counts = fresh.counts
                    h.n = fresh.n
                    h.total = fresh.total
                    h.vmin = fresh.vmin
                    h.vmax = fresh.vmax
                    h.exemplars = fresh.exemplars
        if serve_counters is not None:
            self.counters.groups[SERVE_GROUP] = {
                str(k): int(v) for k, v in serve_counters.items()}
        return self


class SLOBoard:
    """The per-model monitor collection a :class:`PredictionServer`
    owns.  ``observe`` evaluates one model and (when its breaker is
    wired) feeds the sustained-violation soft-degrade signal; ``section``
    is the dict the ``health`` command reports."""

    def __init__(self, config):
        self.config = config
        self.window_sec = config.get_float(KEY_WINDOW_SEC,
                                           DEFAULT_WINDOW_SEC)
        self.degrade_evals = config.get_int(KEY_DEGRADE_EVALS,
                                            DEFAULT_DEGRADE_EVALS)
        self._default_p99 = config.get_float(KEY_P99_MS, 0.0)
        self._default_err = config.get_float(KEY_ERROR_PCT, 0.0)
        self._monitors: Dict[str, ModelSLO] = {}
        self._lock = sanitizer.make_lock("serve.slo.board")

    def monitor(self, name: str,
                config_name: Optional[str] = None) -> ModelSLO:
        """The monitor keyed ``name``; per-model target overrides are
        resolved against ``config_name`` (a replica pool monitors each
        VARIANT group under ``model@variant`` while the declared targets
        stay per-model — ``serve.model.<model>.slo.*``)."""
        with self._lock:
            mon = self._monitors.get(name)
            if mon is None:
                cfg = self.config
                model = config_name or name
                mon = self._monitors[name] = ModelSLO(
                    name,
                    p99_ms=cfg.get_float(
                        f"serve.model.{model}.slo.p99.ms", self._default_p99),
                    error_pct=cfg.get_float(
                        f"serve.model.{model}.slo.error.pct",
                        self._default_err),
                    window_sec=self.window_sec,
                    degrade_evals=self.degrade_evals)
            return mon

    def drop_model(self, name: str) -> None:
        """Forget a model's monitors (the bare key and every
        ``model@variant`` key) — the model-cache demote path: thousands
        of tenants cycling through residency must not grow the board
        without bound, and a re-promoted model's fresh replica set
        deserves a fresh window."""
        with self._lock:
            for k in [k for k in self._monitors
                      if k == name or k.startswith(name + "@")]:
                del self._monitors[k]

    def peek(self, name: str) -> Optional[Dict[str, object]]:
        """Last evaluated window stats for one monitor WITHOUT creating
        it or re-evaluating (the router's read path; None before the
        first observation)."""
        with self._lock:
            mon = self._monitors.get(name)
            return dict(mon.last) if mon is not None else None

    def observe(self, name: str, batcher, now: Optional[float] = None,
                config_name: Optional[str] = None) -> dict:
        mon = self.monitor(name, config_name=config_name)
        stats = mon.observe(batcher, now=now)
        brk = batcher.breaker
        if brk is not None and mon.degrade_evals > 0:
            if stats["sustained"]:
                reason = (f"SLO sustained violation: windowed "
                          f"p99={stats['p99_ms']}ms "
                          f"(target {mon.p99_ms or '-'}ms), "
                          f"errors={stats['error_pct']}% "
                          f"(target {mon.error_pct or '-'}%)")
                was_degraded = brk.soft_degraded
                brk.set_soft_degraded(True, reason)
                if not was_degraded:
                    # edge-triggered anomaly: the moment a variant goes
                    # soft-degraded, dump the black box (re-evaluations
                    # of an already-degraded window stay quiet)
                    flight.trigger("slo_soft_degrade", monitor=name,
                                   detail=reason)
            elif not stats["violation"]:
                brk.set_soft_degraded(False)
        return stats

    def section(self) -> Dict[str, dict]:
        """Last evaluated window stats per model (the ``health`` /
        ``stats`` surface)."""
        with self._lock:
            return {name: dict(mon.last)
                    for name, mon in sorted(self._monitors.items())}
