"""Per-model circuit breaker: shed fast when the scorer is failing.

Clipper's serving contract (Crankshaw et al., NSDI 2017) is that an
unhealthy model should DEGRADE — fast, explicit errors — rather than
stall clients behind a queue of doomed work.  The breaker implements the
standard three-state machine over scorer-batch outcomes:

- ``closed``    — healthy; every batch outcome is recorded, and K
  CONSECUTIVE failures (``serve.breaker.failures``) trip the breaker.
- ``open``      — submissions fail immediately with
  :class:`CircuitOpenError` (the frontend returns a ``degraded`` error
  response; no request waits behind a failing scorer).  After
  ``serve.breaker.reset.sec`` the next admission attempt transitions to
  half-open.
- ``half_open`` — a bounded probe window: up to
  ``serve.breaker.probe.requests`` requests are admitted; the first
  probe batch's success closes the breaker, a failure re-opens it (and
  restarts the reset timer).

The breaker guards BATCH-level scorer exceptions (a broken model
artifact, a device failure) — per-row unscorable records are normal
responses and never count.  State is reported through the ``health`` and
``stats`` commands so operators see ``degraded`` models explicitly.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..core import flight, sanitizer

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

KEY_FAILURES = "serve.breaker.failures"
KEY_RESET_SEC = "serve.breaker.reset.sec"
KEY_PROBES = "serve.breaker.probe.requests"

DEFAULT_FAILURES = 8
DEFAULT_RESET_SEC = 5.0
DEFAULT_PROBES = 2


class CircuitOpenError(RuntimeError):
    """Raised by submit() while the model's breaker is open."""


class CircuitBreaker:
    """Thread-safe three-state breaker over batch outcomes."""

    def __init__(self, name: str, failure_threshold: int = DEFAULT_FAILURES,
                 reset_sec: float = DEFAULT_RESET_SEC,
                 probe_requests: int = DEFAULT_PROBES,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure threshold must be >= 1: {failure_threshold}")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_sec = float(reset_sec)
        self.probe_requests = max(int(probe_requests), 1)
        self._clock = clock
        self._lock = sanitizer.make_lock("serve.breaker")
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probes_admitted = 0
        self.trips = 0          # closed/half_open -> open transitions
        self._slo_degraded = False   # soft-degrade (serve.slo monitor)
        self._slo_reason: Optional[str] = None

    @classmethod
    def from_config(cls, config, name: str) -> Optional["CircuitBreaker"]:
        """None when disabled (``serve.breaker.failures`` <= 0)."""
        k = config.get_int(KEY_FAILURES, DEFAULT_FAILURES)
        if k <= 0:
            return None
        return cls(name, failure_threshold=k,
                   reset_sec=config.get_float(KEY_RESET_SEC,
                                              DEFAULT_RESET_SEC),
                   probe_requests=config.get_int(KEY_PROBES,
                                                 DEFAULT_PROBES))

    # -- admission (submit side) -------------------------------------------
    def allow(self) -> bool:
        """Whether one request may be admitted right now; drives the
        open -> half_open transition when the reset window has passed."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if (self._clock() - self._opened_at) < self.reset_sec:
                    return False
                self._state = HALF_OPEN
                self._probes_admitted = 0
            # half-open: a bounded probe window
            if self._probes_admitted >= self.probe_requests:
                return False
            self._probes_admitted += 1
            return True

    # -- outcomes (worker side) --------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._opened_at = None

    def record_failure(self, trace_id: Optional[str] = None) -> bool:
        """Record one batch failure; returns True when THIS failure
        tripped the breaker (closed/half-open -> open).  A trip is an
        anomaly: the flight recorder dumps its ring, named by the
        offending request's ``trace_id`` when the caller has one."""
        tripped = False
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                # the probe failed: back to open, restart the timer
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                tripped = True
            elif (self._state == CLOSED
                  and self._consecutive >= self.failure_threshold):
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                tripped = True
        if tripped:
            flight.trigger("breaker_trip", trace_id=trace_id,
                           breaker=self.name,
                           consecutive_failures=self.failure_threshold)
        return tripped

    # -- soft degrade (the SLO monitor's signal) ---------------------------
    def set_soft_degraded(self, flag: bool,
                          reason: Optional[str] = None) -> None:
        """SLO-sustained-violation signal (serve/slo.py): does NOT gate
        admission — requests keep flowing — but the model reports
        degraded through ``health``/``stats``/the breaker-state gauge,
        and the variant router (router.py) reads exactly this bit
        to demote a variant before the hard breaker ever trips."""
        with self._lock:
            self._slo_degraded = bool(flag)
            self._slo_reason = reason if flag else None

    @property
    def soft_degraded(self) -> bool:
        with self._lock:
            return self._slo_degraded

    # -- reporting ---------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def degraded(self) -> bool:
        with self._lock:
            return self._state != CLOSED or self._slo_degraded

    def state_code(self) -> int:
        """The breaker state as a gauge value: 0 closed, 1 half-open,
        2 open (the telemetry exporter's 0/1/2 encoding)."""
        return {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}[self.state]

    def state_dict(self) -> dict:
        with self._lock:
            d = {"state": self._state,
                 "consecutive_failures": self._consecutive,
                 "failure_threshold": self.failure_threshold,
                 "trips": self.trips,
                 "slo_degraded": self._slo_degraded}
            if self._slo_reason:
                d["slo_reason"] = self._slo_reason
            if self._opened_at is not None:
                d["open_age_sec"] = round(self._clock() - self._opened_at, 3)
            return d
