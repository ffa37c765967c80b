"""The open-loop client fleet: execute a schedule against a live port.

Each worker thread owns one persistent TCP connection (the frontend is
an event loop, so connections are cheap — but a production client holds
its socket) and its deterministic slice of the phase schedule.  The
contract that makes the numbers honest:

- **Intended-start accounting.**  Every event carries the offset it was
  *supposed* to start at.  A worker that falls behind does NOT skip or
  re-space events — it fires immediately, and the recorded latency runs
  from the intended start, so server backlog surfaces in the
  percentiles instead of silently shrinking the offered rate (the
  coordinated-omission fix; closed-loop clients understate tail latency
  under queueing by construction).
- **No coordination.**  Workers never wait on each other mid-phase;
  the only barrier is the phase boundary (per-phase verdicts need a
  clean cut).

Client-side observations land in the fleet's OWN ``obs.Metrics``
registry — one latency histogram per phase (with trace-id exemplars
from the server's sampled/errorish responses) plus outcome counters —
which the runner merges with the server's snapshot via
``telemetry.merge_snapshots`` into the run's single telemetry artifact.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, List, Optional

from ..core import obs, telemetry
from .generators import Event, partition

#: outcome classes the verdict engine judges; "deferred" is the
#: documented cold_start/quota_exceeded retry signal (a correct client
#: retries — the harness counts it separately from hard errors)
OUTCOMES = ("ok", "error", "shed", "poison", "timeout", "deferred")


class PhaseStats:
    """One phase's fleet-side aggregates (merged across workers after
    the join — no cross-thread mutation)."""

    __slots__ = ("name", "sent", "outcomes", "latencies_ms",
                 "innocents_dropped", "worst", "duration_s", "offered")

    def __init__(self, name: str):
        self.name = name
        self.sent = 0
        self.outcomes: Dict[str, int] = {k: 0 for k in OUTCOMES}
        self.latencies_ms: List[float] = []
        self.innocents_dropped = 0
        #: (latency_ms, trace_id, kind, tenant) of the slowest event —
        #: the worst-offender exemplar a failing verdict ships to the
        #: flight recorder
        self.worst: Optional[tuple] = None
        self.duration_s = 0.0
        self.offered = 0

    def merge(self, other: "PhaseStats") -> None:
        self.sent += other.sent
        for k, v in other.outcomes.items():
            self.outcomes[k] += v
        self.latencies_ms.extend(other.latencies_ms)
        self.innocents_dropped += other.innocents_dropped
        if other.worst is not None and (self.worst is None
                                        or other.worst[0] > self.worst[0]):
            self.worst = other.worst

    def percentile_ms(self, q: float) -> Optional[float]:
        if not self.latencies_ms:
            return None
        xs = sorted(self.latencies_ms)
        i = min(max(int(q * len(xs) + 0.999999) - 1, 0), len(xs) - 1)
        return xs[i]

    def fraction(self, outcome: str) -> float:
        return self.outcomes[outcome] / self.sent if self.sent else 0.0

    def summary(self) -> dict:
        return {
            "sent": self.sent,
            "offered": self.offered,
            "duration_s": round(self.duration_s, 3),
            "achieved_rps": round(self.sent / self.duration_s, 2)
            if self.duration_s else 0.0,
            "outcomes": dict(self.outcomes),
            "innocents_dropped": self.innocents_dropped,
            "p50_ms": _r3(self.percentile_ms(0.50)),
            "p95_ms": _r3(self.percentile_ms(0.95)),
            "p99_ms": _r3(self.percentile_ms(0.99)),
            "max_ms": _r3(max(self.latencies_ms)
                          if self.latencies_ms else None),
            "worst": ({"latency_ms": _r3(self.worst[0]),
                       "trace_id": self.worst[1], "kind": self.worst[2],
                       "tenant": self.worst[3]}
                      if self.worst is not None else None),
        }


def _r3(v: Optional[float]) -> Optional[float]:
    return round(v, 3) if v is not None else None


class LineClient:
    """One persistent JSON-lines connection (reconnects lazily after a
    transport error so a single reset does not sink the worker)."""

    def __init__(self, host: str, port: int, timeout_s: float):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._buf = b""
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def call(self, obj: dict) -> dict:
        """One request/response round trip; raises ``OSError`` on
        transport failure (the caller counts it and the next call
        reconnects)."""
        try:
            sock = self._connect()
            sock.sendall((json.dumps(obj) + "\n").encode())
            while b"\n" not in self._buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise OSError("connection closed mid-response")
                self._buf += chunk
            line, self._buf = self._buf.split(b"\n", 1)
            return json.loads(line.decode())
        except OSError:
            self.close()
            raise


def _wire_request(ev: Event, model_for: Dict[str, str]) -> dict:
    if ev.kind == "feedback":
        return {"cmd": "feedback", "event": ev.rows[0]}
    if ev.kind == "decide":
        return {"model": model_for.get(ev.tenant, ev.tenant),
                "decide": ev.rows[0]}
    model = model_for.get(ev.tenant, ev.tenant)
    if len(ev.rows) == 1:
        return {"model": model, "row": ev.rows[0]}
    return {"model": model, "rows": ev.rows}


def classify(resp: dict) -> str:
    """Map one wire response onto its outcome class (the server's
    structured signals: shed / poison / timeout / cold_start /
    quota_exceeded / error; anything else is a success)."""
    if resp.get("shed"):
        return "shed"
    if resp.get("poison"):
        return "poison"
    if resp.get("timeout"):
        return "timeout"
    if resp.get("cold_start") or resp.get("quota_exceeded"):
        return "deferred"
    if "error" in resp:
        return "error"
    return "ok"


class Fleet:
    """The multi-threaded open-loop driver for one scenario run."""

    def __init__(self, host: str, port: int, threads: int,
                 timeout_s: float, metrics: Optional[obs.Metrics] = None,
                 model_for: Optional[Dict[str, str]] = None):
        self.host = host
        self.port = port
        self.threads = max(int(threads), 1)
        self.timeout_s = timeout_s
        #: the fleet's private registry: merged into the run snapshot by
        #: the runner (client-side and server-side metric names are
        #: disjoint, so the merge is a union, not a double count)
        self.metrics = metrics if metrics is not None else obs.Metrics()
        self.model_for = model_for or {}

    # -- one worker --------------------------------------------------------
    def _run_slice(self, events: List[Event], t0: float,
                   stats: PhaseStats, poison_phase: bool) -> None:
        client = LineClient(self.host, self.port, self.timeout_s)
        hist = self.metrics.histogram(
            telemetry.labeled("workload.latency", phase=stats.name))
        counters = self.metrics.counters
        tracer = obs.get_tracer()
        try:
            for ev in events:
                intended = t0 + ev.offset_s
                delay = intended - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                stats.sent += 1
                counters.incr("Workload", "Requests sent")
                try:
                    resp = client.call(_wire_request(ev, self.model_for))
                except (OSError, ValueError) as e:
                    resp = {"error": f"transport: {e}"}
                lat_s = time.monotonic() - intended
                outcome = classify(resp)
                stats.outcomes[outcome] += 1
                counters.incr("Workload", f"Outcome {outcome}")
                if poison_phase and not ev.poison and outcome not in (
                        "ok", "deferred"):
                    # a well-formed request harmed during the storm: the
                    # zero-dropped-innocents envelope counts exactly this
                    stats.innocents_dropped += 1
                    counters.incr("Workload", "Innocents dropped")
                lat_ms = lat_s * 1000.0
                trace_id = resp.get("trace_id")
                hist.record(lat_s, trace_id=trace_id)
                stats.latencies_ms.append(lat_ms)
                if stats.worst is None or lat_ms > stats.worst[0]:
                    stats.worst = (lat_ms, trace_id, ev.kind, ev.tenant)
                if tracer.enabled and outcome != "ok":
                    tracer.record_span(
                        "workload.anomaly",
                        time.perf_counter_ns() - int(lat_s * 1e9),
                        int(lat_s * 1e9), parent=None,
                        outcome=outcome, phase=stats.name,
                        tenant=ev.tenant,
                        trace=trace_id or "")
        finally:
            client.close()

    # -- one phase ---------------------------------------------------------
    def run_phase(self, name: str, events: List[Event],
                  poison_phase: bool = False) -> PhaseStats:
        """Execute one phase's schedule open-loop; returns the merged
        fleet-side stats.  Workers are joined before return — the phase
        boundary is the run's only barrier."""
        tracer = obs.get_tracer()
        slices = partition(events, self.threads)
        per_thread = [PhaseStats(name) for _ in slices]
        started = time.monotonic()
        with tracer.span("workload.phase", phase=name,
                         events=len(events)):
            t0 = time.monotonic() + 0.05    # common epoch: workers align
            workers = [
                threading.Thread(
                    target=self._run_slice,
                    args=(sl, t0, st, poison_phase),
                    name=f"workload-client-{i}", daemon=True)
                for i, (sl, st) in enumerate(zip(slices, per_thread))]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
        stats = PhaseStats(name)
        for st in per_thread:
            stats.merge(st)
        stats.duration_s = time.monotonic() - started
        stats.offered = len(events)
        self.metrics.set_gauge(
            telemetry.labeled("workload.achieved.rps", phase=name),
            stats.sent / stats.duration_s if stats.duration_s else 0.0)
        return stats
