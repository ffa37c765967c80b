"""The router's coordination loops: replica autoscaling + residency.

Both loops run on one ``avenir-fleet-control`` thread (joined on stop)
because they act on the same signals and must not fight each other.

**Autoscaling** (INFaaS-style, PAPERS.md): per control tick the router
computes each model's observed fleet arrival rate (its own forwarded
counters diffed over the tick — the router sees every request, so no
feed lag) and targets ``ceil(rate / router.autoscale.qps.per.replica)``
replicas per backend, clamped to
``router.autoscale.{min,max}.replicas``.  Scale commands ride the
backend's ``{"cmd": "scale"}`` verb, whose grow path is the pre-swap
replica build — nothing observable changes on the backend until the new
replicas fully exist.  Decisions are deliberately sluggish: at most one
scale action per model per ``router.autoscale.hold.sec``, and a DOWN
decision must persist for a full hold window before it fires (scale-up
hysteresis is asymmetric on purpose — adding capacity late costs p99,
removing it late costs only memory).

**Residency coordination** (model-cache tenants): with
``router.residency.replicas=k`` configured, the loop watches the feed
residency view and promote-nudges a model seen in traffic onto the
least-loaded backends until exactly k hold it resident — instead of all
N backends independently promoting the same hot tenant.  Dispatch
prefers resident backends on its own (the SLO verdicts and cold-start
flags already demote non-resident ones); the loop only fixes the
steady-state shape.

**Replicated routers** (lease.py): with N routers over one spool, only
the lease HOLDER runs the two loops above — followers dispatch only,
and every scale command the leader issues carries the lease generation
so a deposed leader's in-flight decision is refused by the backend
pool.  **Quarantine propagation** runs on EVERY router regardless of
leadership (``serve.breaker.propagate``): seeding a sibling's
quarantined poison signatures is idempotent (the backend folds by
max), and a propagation gap during a leadership hand-off would be
exactly the window a poison storm exploits.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

from ...core import flight, sanitizer
from .backend import BackendLink

KEY_AUTOSCALE = "router.autoscale.enable"
KEY_QPS_PER_REPLICA = "router.autoscale.qps.per.replica"
KEY_MIN_REPLICAS = "router.autoscale.min.replicas"
KEY_MAX_REPLICAS = "router.autoscale.max.replicas"
KEY_HOLD_SEC = "router.autoscale.hold.sec"
KEY_RESIDENCY_K = "router.residency.replicas"
KEY_CONTROL_SEC = "router.control.interval.sec"
KEY_PROPAGATE = "serve.breaker.propagate"

DEFAULT_QPS_PER_REPLICA = 50.0
DEFAULT_MIN_REPLICAS = 1
DEFAULT_MAX_REPLICAS = 4
DEFAULT_HOLD_SEC = 10.0
DEFAULT_CONTROL_SEC = 2.0

COMMAND_TIMEOUT_SEC = 15.0

THREAD_NAME = "avenir-fleet-control"


class ControlLoop:
    """Rate-limited, hysteretic fleet control over the backend links."""

    def __init__(self, config, links: List[BackendLink], watch,
                 rates_fn: Callable[[], Dict[str, float]],
                 lease=None):
        self.links = links
        self.watch = watch          # Optional[FeedWatch]
        self.rates_fn = rates_fn
        self.lease = lease          # Optional[RouterLease]
        self.propagate = config.get_boolean(KEY_PROPAGATE, True)
        self.autoscale = config.get_boolean(KEY_AUTOSCALE, False)
        self.qps_per_replica = config.get_float(KEY_QPS_PER_REPLICA,
                                                DEFAULT_QPS_PER_REPLICA)
        self.min_replicas = config.get_int(KEY_MIN_REPLICAS,
                                           DEFAULT_MIN_REPLICAS)
        self.max_replicas = config.get_int(KEY_MAX_REPLICAS,
                                           DEFAULT_MAX_REPLICAS)
        self.hold_sec = config.get_float(KEY_HOLD_SEC, DEFAULT_HOLD_SEC)
        self.residency_k = config.get_int(KEY_RESIDENCY_K, 0)
        self.interval = config.get_float(KEY_CONTROL_SEC,
                                         DEFAULT_CONTROL_SEC)
        self._lock = sanitizer.make_lock("fleet.control")
        self._issued: Dict[str, int] = {}       # model -> last scale sent
        self._last_scale: Dict[str, float] = {}
        self._down_since: Dict[str, float] = {}
        # backend -> model -> signatures already pushed: bounds
        # steady-state propagation chatter (the verb itself is
        # idempotent, so losing this ledger on restart is harmless)
        self._seeded: Dict[str, Dict[str, set]] = {}
        self.scale_ups = 0
        self.scale_downs = 0
        self.promotes = 0
        self.quarantine_pushes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _is_leader(self) -> bool:
        """Leadership gate: with no lease configured (a single router,
        or no spool) this router IS the leader."""
        return self.lease is None or self.lease.is_leader()

    # -- one tick ----------------------------------------------------------
    def step(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else float(now)
        rates = self.rates_fn()
        if self._is_leader():
            if self.autoscale and self.qps_per_replica > 0:
                for model in sorted(rates):
                    self._autoscale_model(model, rates[model], now)
            if self.residency_k > 0 and self.watch is not None:
                for model in sorted(rates):
                    self._nudge_residency(model)
        if self.propagate and self.watch is not None:
            self._propagate_quarantine()

    def _current_replicas(self, model: str) -> int:
        with self._lock:
            issued = self._issued.get(model)
        if issued is not None:
            return issued
        if self.watch is not None:
            observed = self.watch.replicas(model)
            if observed:
                return max(observed.values())
        return self.min_replicas

    def _autoscale_model(self, model: str, rate: float,
                         now: float) -> None:
        desired = min(self.max_replicas,
                      max(self.min_replicas,
                          int(math.ceil(rate / self.qps_per_replica)))
                      if rate > 0 else self.min_replicas)
        current = self._current_replicas(model)
        with self._lock:
            last = self._last_scale.get(model, -self.hold_sec)
            if desired == current:
                self._down_since.pop(model, None)
                return
            if desired > current:
                self._down_since.pop(model, None)
                if now - last < self.hold_sec:
                    return
            else:
                t0 = self._down_since.setdefault(model, now)
                if now - t0 < self.hold_sec or now - last < self.hold_sec:
                    return
                self._down_since.pop(model, None)
            self._last_scale[model] = now
            self._issued[model] = desired
            if desired > current:
                self.scale_ups += 1
            else:
                self.scale_downs += 1
        # fan out OFF the lock: scale commands block on replica builds.
        # The lease generation rides every command — the pool-side
        # fence against a deposed leader's in-flight decision
        cmd = {"cmd": "scale", "model": model, "replicas": desired}
        if self.lease is not None:
            cmd["generation"] = self.lease.generation()
        acks = 0
        for link in self.links:
            resp = link.command(dict(cmd), COMMAND_TIMEOUT_SEC)
            if resp is not None and resp.get("ok"):
                acks += 1
        flight.record("fleet.autoscale", model=model, rate=round(rate, 2),
                      replicas=desired, previous=current, acks=acks,
                      generation=cmd.get("generation"))

    def _nudge_residency(self, model: str) -> None:
        resident = set(self.watch.residency(model))
        missing = self.residency_k - len(resident)
        if missing <= 0:
            return
        candidates = sorted(
            (link for link in self.links
             if link.name not in resident and link.alive()),
            key=lambda link: link.inflight())
        for link in candidates[:missing]:
            resp = link.command(
                {"cmd": "promote", "model": model, "wait": False},
                COMMAND_TIMEOUT_SEC)
            # backends without a model cache answer with an error —
            # residency nudging simply does not apply to them
            if resp is not None and "error" not in resp:
                with self._lock:
                    self.promotes += 1

    def _propagate_quarantine(self) -> None:
        """Push fleet-sighted quarantined poison signatures to every
        backend whose own feed has not shown them: a row one backend
        quarantined is refused at submit by every sibling BEFORE its
        first scorer failure there.  Seeding folds by max on the
        backend (idempotent), so the only cost of over-pushing is
        chatter — bounded by the _seeded ledger."""
        sightings = self.watch.quarantine_sightings()
        if not sightings:
            return
        for link in self.links:
            have = self.watch.backend_quarantine(link.name)
            to_push = []
            with self._lock:
                ledger = self._seeded.setdefault(link.name, {})
                for model, sigs in sightings.items():
                    known = have.get(model, {})
                    pushed = ledger.setdefault(model, set())
                    fresh = {sig: n for sig, n in sigs.items()
                             if sig not in known and sig not in pushed}
                    if fresh:
                        # remembered even if the push fails: a backend
                        # without the model (or with quarantine off)
                        # answers with an error, and one sick backend
                        # must not make every tick re-knock on it
                        pushed.update(fresh)
                        to_push.append((model, fresh))
            # commands OFF the lock: they block on the backend
            for model, fresh in to_push:
                resp = link.command(
                    {"cmd": "quarantine", "model": model,
                     "signatures": fresh}, COMMAND_TIMEOUT_SEC)
                if resp is not None and "error" not in resp:
                    with self._lock:
                        self.quarantine_pushes += 1
                    flight.record("fleet.quarantine_propagated",
                                  backend=link.name, model=model,
                                  signatures=len(fresh))

    def section(self) -> dict:
        with self._lock:
            return {"autoscale": self.autoscale,
                    "leader": self._is_leader(),
                    "propagate": self.propagate,
                    "residency_replicas": self.residency_k,
                    "scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs,
                    "promotes": self.promotes,
                    "quarantine_pushes": self.quarantine_pushes,
                    "issued": dict(self._issued)}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ControlLoop":
        enabled = (self.autoscale or self.residency_k > 0
                   or (self.propagate and self.watch is not None))
        if not enabled or self.interval <= 0 or self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.step()
                except Exception:                       # noqa: BLE001
                    pass        # one bad tick must not kill control

        self._thread = threading.Thread(target=run, name=THREAD_NAME,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None
