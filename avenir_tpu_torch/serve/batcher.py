"""Dynamic micro-batching queue with admission control.

Requests accumulate until ``serve.batch.max.size`` are waiting or the
OLDEST enqueued request has waited ``serve.batch.max.delay.ms`` — the
Clipper-style adaptive batching trade: the delay bounds worst-case queue
latency, the size bounds device memory, and the engine pads whatever
arrived to a power-of-two bucket so the jitted scorer hits a warmed
compiled shape (see engine.py).

Admission control: a queue deeper than ``serve.queue.max.depth`` SHEDS new
requests (``ShedError`` + the ``Serve / Shed`` counter) so overload
degrades to fast-fail instead of growing an unbounded queue — the
graceful-degradation half of the adaptive-batching literature.

Each model gets one batcher (and one worker thread): per-model scorer
state — the encoder vocabularies, the compiled-function cache, the device
tables — is therefore only ever touched by one thread at a time, while
the shared bounded caches underneath stay lock-protected for the
warmup/reload paths (utils.caches).

Observability (core.obs): per-request end-to-end and queue-wait latency
go into shared :class:`LatencyHistogram` s (bounded memory, mergeable,
p50/p95/p99 from log-bucket interpolation — replacing the old raw-sample
sort that grew and re-sorted a window on every stats call), and the
worker emits ``serve.batch`` / ``serve.queue.wait`` / ``serve.assemble``
/ ``serve.score`` spans plus a queue-depth gauge when tracing is on.

Graceful degradation (this PR's resilience layer):

- **Deadlines** — with ``serve.request.deadline.ms`` set, a request that
  is still queued past its deadline gets a ``TimeoutError`` at drain
  time (the frontend renders a timeout error response) instead of being
  scored late; no client ever waits past its deadline for a response.
- **Circuit breaker** — batch-level scorer failures feed the per-model
  :class:`serve.breaker.CircuitBreaker`; while open, ``submit`` fails
  fast with ``CircuitOpenError``.
- **Worker watchdog** — :meth:`ensure_worker` restarts a dead dispatch
  worker (called defensively on submit and periodically by the server's
  watchdog thread), so a single escaped exception can never permanently
  wedge the queue: pending requests are drained by the replacement.

Poison-batch isolation (``serve.poison.*``; README "Fault tolerance"):
micro-batching co-schedules unrelated clients' rows, so ONE hostile row
used to fail its whole batch — innocent cohabitants got the scorer's
exception and the shared breaker counted a failure for everyone.  With
``serve.poison.isolate=true``, a failed batch is BISECT-RESCORED: halves
re-score recursively until the offending row(s) are isolated as
singletons.  Innocent rows get their real results; only poison rows get
a structured :class:`PoisonRowError`; the breaker records a SUCCESS
(the scorer is demonstrably healthy — it scored the innocents) unless
every row of a MULTI-row batch fails alone, which is a systemic scorer
failure and feeds the breaker exactly as before.  A failed SINGLETON
batch is locally indistinguishable from poison, so history breaks the
tie: a row with recorded offenses is a KNOWN offender and classifies
poison unconditionally (a hot lone poison client accumulates to
quarantine and never trips the breaker), and a NEW row classifies
poison only when the previous batch scored something — a new row
failing right after a fully-failed batch is consecutive total failure,
which is scorer-shaped and feeds the breaker as systemic (so a
genuinely sick scorer under batch-size-1 traffic still trips it, and
innocent retried rows stop accumulating quarantine offenses once the
systemic classification takes over).  Repeat offenders land in a bounded
:class:`PoisonQuarantine` signature cache (shared across a model's
replicas) and are refused AT SUBMIT after
``serve.poison.quarantine.threshold`` offenses — a hot poison client
stops costing scorer time at all.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, List, Optional

from ..core import faultinject, flight, sanitizer, telemetry
from ..core.metrics import Counters
from ..core.obs import LatencyHistogram, TraceContext, get_tracer
from .breaker import CircuitBreaker, CircuitOpenError

SERVE_GROUP = "Serve"

KEY_POISON_ISOLATE = "serve.poison.isolate"
KEY_POISON_THRESHOLD = "serve.poison.quarantine.threshold"
KEY_POISON_CACHE = "serve.poison.cache.size"

DEFAULT_POISON_THRESHOLD = 3
DEFAULT_POISON_CACHE = 1024


class ShedError(RuntimeError):
    """Raised by submit() when the queue is at ``serve.queue.max.depth``."""


class PoisonRowError(RuntimeError):
    """A row individually failed the scorer (isolated by bisect) or was
    refused at submit after repeat offenses — a PER-ROW structured
    error: cohabiting rows in the same wire request/micro-batch are
    unaffected, and poison failures never feed the circuit breaker."""


class PoisonQuarantine:
    """Bounded LRU signature cache of repeat-offender rows, shared by
    every replica (and variant) of one model.

    ``record`` counts an isolated poison failure for a row's signature;
    once a signature reaches ``threshold`` offenses, ``quarantined``
    turns true and submits of that row are refused immediately with
    :class:`PoisonRowError` — no queue slot, no scorer time, no bisect.
    The cache is capped at ``serve.poison.cache.size`` signatures
    (least-recently-offended evicted), so an adversarial stream of
    unique poison rows cannot grow it without bound."""

    def __init__(self, threshold: int = DEFAULT_POISON_THRESHOLD,
                 cap: int = DEFAULT_POISON_CACHE):
        self.threshold = max(1, int(threshold))
        self.cap = max(1, int(cap))
        self._counts: "OrderedDict[str, int]" = OrderedDict()
        self._lock = sanitizer.make_lock("serve.poison.quarantine")

    @classmethod
    def from_config(cls, config) -> Optional["PoisonQuarantine"]:
        """None when quarantine is disabled
        (``serve.poison.quarantine.threshold=0``)."""
        threshold = config.get_int(KEY_POISON_THRESHOLD,
                                   DEFAULT_POISON_THRESHOLD)
        if threshold <= 0:
            return None
        return cls(threshold,
                   config.get_int(KEY_POISON_CACHE, DEFAULT_POISON_CACHE))

    @staticmethod
    def signature(line: str) -> str:
        return hashlib.sha1(line.encode("utf-8", "replace")).hexdigest()[:16]

    def record(self, line: str) -> int:
        """Count one isolated poison failure; returns the new offense
        count for the row's signature."""
        sig = self.signature(line)
        with self._lock:
            n = self._counts.pop(sig, 0) + 1
            self._counts[sig] = n
            while len(self._counts) > self.cap:
                self._counts.popitem(last=False)
            return n

    def quarantined(self, line: str) -> bool:
        sig = self.signature(line)
        with self._lock:
            n = self._counts.get(sig)
            if n is None:
                return False
            self._counts.move_to_end(sig)
            return n >= self.threshold

    def offenses(self, line: str) -> int:
        """Recorded offense count for the row (0 = never seen): a row
        with history is a KNOWN offender — the batcher's singleton
        tie-breaker classifies its repeat failures as poison even
        right after a fully-failed batch."""
        with self._lock:
            return self._counts.get(self.signature(line), 0)

    def size(self) -> int:
        with self._lock:
            return len(self._counts)

    def export(self) -> dict:
        """The QUARANTINED signatures (offense count at/over threshold)
        with their counts — the fleet-propagation payload the serve
        telemetry overlay ships in the snapshot's ``resilience``
        section.  Sub-threshold offenders stay local: a sibling only
        needs the verdicts, not the evidence in progress."""
        with self._lock:
            return {sig: n for sig, n in self._counts.items()
                    if n >= self.threshold}

    def seed(self, sig: str, offenses: int) -> bool:
        """Install a sibling-observed signature at
        ``max(local, offenses)`` offenses — idempotent (re-seeding never
        lowers a count), so the router may re-push after a restart.
        Returns True when the signature newly crossed the quarantine
        threshold HERE — the propagation counters' input."""
        n = max(1, int(offenses))
        with self._lock:
            cur = self._counts.pop(sig, 0)
            new = max(cur, n)
            self._counts[sig] = new
            while len(self._counts) > self.cap:
                self._counts.popitem(last=False)
            return cur < self.threshold <= new

    def clear(self) -> None:
        """Forget every offense (a model reload may have repaired the
        scorer-side cause, so quarantined rows deserve a fresh trial)."""
        with self._lock:
            self._counts.clear()


class _Request:
    __slots__ = ("line", "future", "t_enqueue", "deadline", "ctx")

    def __init__(self, line: str, deadline_s: float = 0.0,
                 ctx: Optional[TraceContext] = None):
        self.line = line
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        # absolute drop-dead time on the same clock (0 = no deadline)
        self.deadline = (self.t_enqueue + deadline_s) if deadline_s else 0.0
        # the wire request's causal trace context: travels WITH the
        # request across the submit-thread -> worker-thread boundary so
        # the worker's fan-in spans link back to the request's trace
        self.ctx = ctx


class MicroBatcher:
    """One model's request queue + dispatch worker."""

    def __init__(self, name: str,
                 predict_fn: Callable[[List[str]], List[Optional[str]]],
                 counters: Counters,
                 max_batch: int = 64,
                 max_delay_ms: float = 2.0,
                 max_queue_depth: int = 256,
                 hist_buckets: Optional[int] = None,
                 deadline_ms: float = 0.0,
                 breaker: Optional[CircuitBreaker] = None,
                 fault_tag: Optional[str] = None,
                 poison_isolate: bool = False,
                 quarantine: Optional[PoisonQuarantine] = None):
        self.name = name
        self.predict_fn = predict_fn
        self.counters = counters
        # call-site tag for the scorer fault points: a replica pool sets
        # the model VARIANT so a plan like scorer_slow[f32]@*:40 slows
        # exactly one variant's scorers (the router-demotion test)
        self.fault_tag = fault_tag
        self.poison_isolate = bool(poison_isolate)
        # shared across the model's replicas (the pool passes one), so a
        # poison client bouncing between replicas still accumulates
        self.quarantine = quarantine
        self.max_batch = max(1, int(max_batch))
        self.max_delay = max(0.0, float(max_delay_ms)) / 1000.0
        self.max_queue_depth = max(1, int(max_queue_depth))
        self.deadline_s = max(0.0, float(deadline_ms)) / 1000.0
        self.breaker = breaker
        self._q: deque = deque()
        self._cv = sanitizer.make_condition("serve.batcher.cv")
        self._closed = False
        # did the previous batch fail in its entirety?  Breaks the
        # poison-vs-systemic tie for failed SINGLETON batches: one
        # failure after demonstrated health is poison; consecutive
        # total failure is scorer-shaped and feeds the breaker
        self._last_all_failed = False
        # per-request latency distributions: the shared log-bucketed
        # histogram (core.obs) — bounded memory under sustained traffic,
        # internally locked, mergeable across batchers
        hkw = {"n_buckets": hist_buckets} if hist_buckets else {}
        self.e2e_hist = LatencyHistogram(**hkw)
        self.queue_wait_hist = LatencyHistogram(**hkw)
        self._worker = self._start_worker()

    def _start_worker(self) -> threading.Thread:
        t = threading.Thread(
            target=self._run, name=f"serve-batcher-{self.name}",
            daemon=True)
        t.start()
        return t

    # -- client side -------------------------------------------------------
    def _admit(self) -> None:
        """One breaker admission check shared by both wire paths."""
        if self.breaker is not None and not self.breaker.allow():
            self.counters.incr(SERVE_GROUP, "Breaker rejected")
            raise CircuitOpenError(
                f"model {self.name!r} circuit breaker is "
                f"{self.breaker.state} after consecutive scorer failures")

    def _quarantine_check(self, line: str) -> Optional[Future]:
        """A pre-resolved PoisonRowError future when the row is
        quarantined (refused at submit — no queue slot, no scorer time),
        else None."""
        if self.quarantine is None or not self.quarantine.quarantined(line):
            return None
        self.counters.incr(SERVE_GROUP, "Poison quarantined submits")
        f: Future = Future()
        f.set_exception(PoisonRowError(
            f"row quarantined after >= {self.quarantine.threshold} "
            f"isolated poison failures (serve.poison.quarantine."
            f"threshold); fix the row or reload the model to clear the "
            f"quarantine"))
        return f

    def submit(self, line: str,
               ctx: Optional[TraceContext] = None) -> Future:
        """Enqueue one request line; the Future resolves to the output
        line (or raises).  Sheds with ShedError past the depth limit;
        fails fast with CircuitOpenError while the model's breaker is
        open; a quarantined poison row resolves immediately to
        PoisonRowError without ever reaching the queue.  ``ctx`` is the
        wire request's trace context (rides the queue entry)."""
        self._admit()
        poisoned = self._quarantine_check(line)
        if poisoned is not None:
            return poisoned
        req = _Request(line, self.deadline_s, ctx)
        with self._cv:
            if self._closed:
                raise RuntimeError(f"batcher {self.name} is closed")
            if len(self._q) >= self.max_queue_depth:
                self.counters.incr(SERVE_GROUP, "Shed")
                raise ShedError(
                    f"queue depth {len(self._q)} at serve.queue.max.depth")
            self._q.append(req)
            self._cv.notify()
        # defensive liveness check: if the dispatch worker died, restart
        # it now so this request is not parked behind a dead thread
        self.ensure_worker()
        return req.future

    def submit_many(self, lines: List[str],
                    ctx: Optional[TraceContext] = None):
        """Enqueue a client-side batch under ONE lock round (the wire
        protocol's ``"rows": [...]`` shape): returns ``(futures, shed)``
        where rows past the queue-depth limit hold ``None`` and count
        into ``shed``.  One breaker admission guards the whole wire
        request (a half-open probe window admits client batches, not
        rows).  Amortizes the per-row lock/notify/liveness cost that
        dominates the event-loop frontend's submit path under load.
        All rows share the wire request's one trace context."""
        self._admit()
        futures: List[Optional[Future]] = []
        shed = 0
        with self._cv:
            if self._closed:
                raise RuntimeError(f"batcher {self.name} is closed")
            room = self.max_queue_depth - len(self._q)
            for line in lines:
                poisoned = self._quarantine_check(line)
                if poisoned is not None:
                    # quarantined row: pre-resolved error, no queue slot
                    futures.append(poisoned)
                    continue
                if room <= 0:
                    self.counters.incr(SERVE_GROUP, "Shed")
                    futures.append(None)
                    shed += 1
                    continue
                req = _Request(line, self.deadline_s, ctx)
                self._q.append(req)
                room -= 1
                futures.append(req.future)
            self._cv.notify()
        self.ensure_worker()
        return futures, shed

    # -- worker side -------------------------------------------------------
    def _drain_batch(self) -> List[_Request]:
        """Block until a batch is ready: max size reached, or the oldest
        request aged past max delay (holding the lock only while
        waiting/draining, never while scoring)."""
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return []
            deadline = self._q[0].t_enqueue + self.max_delay
            while (len(self._q) < self.max_batch and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
                if not self._q:       # closed+drained while waiting
                    return []
                deadline = self._q[0].t_enqueue + self.max_delay
            with get_tracer().span("serve.assemble", model=self.name):
                batch = []
                while self._q and len(batch) < self.max_batch:
                    batch.append(self._q.popleft())
                return batch

    def _expire(self, batch: List[_Request],
                now: float) -> List[_Request]:
        """Drop requests whose deadline passed while queued: they get a
        TimeoutError NOW (the client is already gone or about to give
        up) and the batch scores only live requests."""
        live = []
        for r in batch:
            if r.deadline and now > r.deadline:
                self.counters.incr(SERVE_GROUP, "Deadline expired")
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(TimeoutError(
                        "request deadline exceeded in queue "
                        "(serve.request.deadline.ms)"))
            else:
                live.append(r)
        return live

    def _score_lines(self, lines: List[str]) -> List[Optional[str]]:
        """One scorer invocation with its fault points (shared by the
        main batch path and every bisect rescore sub-batch — a
        content-based ``scorer_poison`` plan re-fails exactly the
        sub-batches still holding the poison row)."""
        fi = faultinject.get_injector()
        if fi is not None:
            fi.fire("scorer", tag=self.fault_tag)
            fi.fire("scorer_slow", tag=self.fault_tag)
            fi.fire_poison(lines, tag=self.fault_tag)
        return self.predict_fn(lines)

    def _isolate(self, batch: List[_Request]):
        """Bisect-rescore a failed batch to isolate the poison row(s):
        halves re-score recursively; a failing SINGLETON is poison.
        Returns ``(outputs, poison)`` where ``poison`` maps batch index
        -> the row's own exception and ``outputs`` carries real results
        for every innocent row.  Cost: innocents re-score O(log n)
        times, bounded by the batch size (<= 2n-1 scorer calls) — paid
        only on failed batches."""
        outputs: List[Optional[str]] = [None] * len(batch)
        poison: dict = {}
        segments = deque([(0, len(batch))])
        while segments:
            lo, hi = segments.popleft()
            lines = [batch[i].line for i in range(lo, hi)]
            try:
                self.counters.incr(SERVE_GROUP, "Poison rescores")
                outs = self._score_lines(lines)
            except Exception as e:              # noqa: BLE001
                if hi - lo == 1:
                    poison[lo] = e
                else:
                    mid = (lo + hi) // 2
                    segments.append((lo, mid))
                    segments.append((mid, hi))
                continue
            outputs[lo:hi] = outs
        return outputs, poison

    def _run(self) -> None:
        try:
            self._run_loop()
        except faultinject.SimulatedWorkerDeath:
            # injected hard death: the thread ends abruptly (observably
            # identical to any BaseException escaping the loop) — the
            # watchdog restart path takes over
            return

    @staticmethod
    def _batch_trace(batch: List[_Request]) -> Optional[str]:
        """The first member's trace id (anomaly dumps name themselves by
        the offending request)."""
        for r in batch:
            if r.ctx is not None:
                return r.ctx.trace_id
        return None

    def _run_loop(self) -> None:
        tracer = get_tracer()
        while True:
            fi = faultinject.get_injector()
            if fi is not None:
                # injected batcher worker death (BaseException: nothing
                # below catches it) — the watchdog restart path
                fi.fire("batcher_death")
            batch = self._drain_batch()
            if not batch:
                with self._cv:
                    if self._closed and not self._q:
                        return
                continue
            t_drain = time.perf_counter()
            batch = self._expire(batch, t_drain)
            if not batch:
                continue
            oldest = min(r.t_enqueue for r in batch)
            sampled = [r for r in batch
                       if r.ctx is not None and r.ctx.sampled]
            for r in batch:
                self.queue_wait_hist.record(
                    t_drain - r.t_enqueue,
                    trace_id=(r.ctx.trace_id
                              if r.ctx is not None and r.ctx.sampled
                              else None))
            if tracer.enabled:
                # queue-wait span: the oldest request's time in queue
                # (recorded retroactively from its enqueue stamp)
                tracer.record_span(
                    "serve.queue.wait", int(oldest * 1e9),
                    int((t_drain - oldest) * 1e9), model=self.name)
                # per-request queue-wait spans, parented to each sampled
                # request's root so the trace shows ITS time in queue
                for r in sampled:
                    tracer.record_span(
                        "serve.queue.wait", int(r.t_enqueue * 1e9),
                        int((t_drain - r.t_enqueue) * 1e9), ctx=r.ctx,
                        model=self.name)
                tracer.gauge(f"serve.{self.name}.queue.depth", self.depth())
            self.counters.incr(SERVE_GROUP, "Requests", len(batch))
            self.counters.incr(SERVE_GROUP, "Batches")
            with tracer.span("serve.batch", model=self.name,
                             batch=len(batch)) as bspan:
                # fan-in linking: the shared batch span carries its
                # member requests' span ids (and joins the first
                # member's trace so Perfetto renders it connected);
                # each member's serve.score span below records this
                # batch span's id — the two directions of the link
                batch_span_id = getattr(bspan, "span_id", None)
                if batch_span_id is not None and sampled:
                    bspan.attrs["members"] = [r.ctx.span_id
                                              for r in sampled]
                    bspan.attrs.setdefault("trace",
                                           sampled[0].ctx.trace_id)
                poison: dict = {}
                try:
                    with tracer.span("serve.score", model=self.name,
                                     batch=len(batch)):
                        outputs = self._score_lines(
                            [r.line for r in batch])
                    self._last_all_failed = False
                except Exception as e:                 # noqa: BLE001
                    if self.poison_isolate:
                        with tracer.span("serve.poison.isolate",
                                         model=self.name,
                                         batch=len(batch)):
                            outputs, poison = self._isolate(batch)
                    known_offender = (
                        len(batch) == 1 and self.quarantine is not None
                        and self.quarantine.offenses(batch[0].line) > 0)
                    if not self.poison_isolate or (
                            len(poison) == len(batch)
                            and (len(batch) > 1
                                 or (self._last_all_failed
                                     and not known_offender))):
                        # isolation off, every row of a MULTI-row batch
                        # fails alone, or a NEW (no offense history)
                        # singleton right after a fully-failed batch —
                        # a systemic scorer failure, not poison: the
                        # pre-existing whole-batch failure path (and
                        # the breaker hears about it).  A known
                        # offender's singleton, or any singleton after
                        # demonstrated health, is classified poison
                        # below: one hostile row alone in a batch must
                        # not feed the breaker, and its offenses must
                        # accumulate toward quarantine.
                        self._last_all_failed = True
                        self.counters.incr(SERVE_GROUP, "Batch errors")
                        # per-request failure accounting: the SLO
                        # monitor's windowed error rate diffs this
                        self.counters.incr(SERVE_GROUP, "Failed requests",
                                           len(batch))
                        tripped = False
                        if self.breaker is not None:
                            tripped = self.breaker.record_failure(
                                trace_id=self._batch_trace(batch))
                        if not tripped:
                            # a trip already dumped the black box inside
                            # record_failure; otherwise the uncaught
                            # scorer exception is the anomaly itself
                            flight.trigger(
                                "scorer_error", model=self.name,
                                trace_id=self._batch_trace(batch),
                                error=f"{type(e).__name__}: {e}")
                        for r in batch:
                            if not r.future.set_running_or_notify_cancel():
                                continue
                            r.future.set_exception(e)
                        continue
                    # poison isolated: innocents scored (or the scorer
                    # demonstrated health on the previous batch) — the
                    # failures do NOT feed the breaker (one hot poison
                    # client must not trip the whole replica for
                    # everyone)
                    self._last_all_failed = len(poison) == len(batch)
                    self.counters.incr(SERVE_GROUP, "Poison batches")
                    self.counters.incr(SERVE_GROUP, "Poison rows",
                                       len(poison))
                    self.counters.incr(SERVE_GROUP, "Failed requests",
                                       len(poison))
                    if self.quarantine is not None:
                        for i in poison:
                            n = self.quarantine.record(batch[i].line)
                            if n == self.quarantine.threshold:
                                # crossing INTO quarantine is the
                                # anomaly (repeat offenses past it are
                                # refused at submit and stay quiet)
                                flight.trigger(
                                    "poison_quarantine", model=self.name,
                                    trace_id=(batch[i].ctx.trace_id
                                              if batch[i].ctx is not None
                                              else None),
                                    offenses=n)
                if self.breaker is not None and len(poison) < len(batch):
                    # at least one row actually scored — demonstrated
                    # health; an all-poison (singleton) batch proved
                    # nothing either way, so the breaker hears nothing
                    self.breaker.record_success()
                # rate-limited device residency sample per scored batch
                telemetry.sample_device_memory()
                done = time.perf_counter()
                for r in batch:
                    self.e2e_hist.record(
                        done - r.t_enqueue,
                        trace_id=(r.ctx.trace_id
                                  if r.ctx is not None and r.ctx.sampled
                                  else None))
                if tracer.enabled:
                    # end-to-end span: oldest enqueue -> results ready
                    tracer.record_span(
                        "serve.e2e", int(oldest * 1e9),
                        int((done - oldest) * 1e9), model=self.name,
                        batch=len(batch))
                    # per-request score spans: each sampled member's
                    # slice of the shared batch, stamped with the batch
                    # span id (the member -> batch half of the fan-in
                    # link)
                    if batch_span_id is not None:
                        for r in sampled:
                            tracer.record_span(
                                "serve.score", int(t_drain * 1e9),
                                int((done - t_drain) * 1e9), ctx=r.ctx,
                                model=self.name, batch=len(batch),
                                batch_span=batch_span_id)
                for i, (r, out) in enumerate(zip(batch, outputs)):
                    if not r.future.set_running_or_notify_cancel():
                        continue
                    if i in poison:
                        r.future.set_exception(PoisonRowError(
                            f"row failed the scorer in isolation "
                            f"(poison row; cohabiting requests "
                            f"unaffected): {poison[i]}"))
                    elif out is None:
                        self.counters.incr(SERVE_GROUP, "Unscorable")
                        r.future.set_exception(
                            ValueError("record not scorable by this model"))
                    else:
                        r.future.set_result(out)

    # -- metrics / lifecycle ----------------------------------------------
    def latency_percentiles_ms(self) -> dict:
        """p50/p95/p99 of end-to-end request latency, in milliseconds —
        estimated from the shared log-bucketed histogram (same JSON field
        names as the old raw-sample implementation, O(buckets) memory
        instead of an ever-resorted sample window)."""
        return self.e2e_hist.percentiles_ms()

    def histograms(self) -> dict:
        """Full latency-distribution snapshots for the stats surface."""
        return {"e2e_ms": self.e2e_hist.snapshot(),
                "queue_wait_ms": self.queue_wait_hist.snapshot()}

    def fill_ratio(self) -> Optional[float]:
        """Requests / padded (bucketed) rows — 1.0 means every scored slot
        carried a real request."""
        padded = self.counters.get(SERVE_GROUP, "Padded rows")
        if not padded:
            return None
        return self.counters.get(SERVE_GROUP, "Requests") / padded

    def clear_latency_window(self) -> None:
        """Reset the latency histograms (load sweeps measure each offered
        load against a fresh window)."""
        self.e2e_hist.reset()
        self.queue_wait_hist.reset()

    def depth(self) -> int:
        with self._cv:
            return len(self._q)

    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    def ensure_worker(self) -> bool:
        """Restart the dispatch worker if it died (an exception escaped
        ``_run`` — e.g. a BaseException from a scorer); returns True
        when a restart happened.  Requests already queued are drained by
        the replacement worker, so a single worker death never wedges
        the queue.  Called defensively from ``submit`` and periodically
        by the server watchdog."""
        with self._cv:
            if self._closed or self._worker.is_alive():
                return False
            self.counters.incr(SERVE_GROUP, "Worker restarts")
            self._worker = self._start_worker()
            return True

    def close(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` pending requests are scored
        first, otherwise they fail.  A DEAD worker cannot drain — once
        ``_closed`` is set ``ensure_worker`` refuses to restart, so
        draining through a dead worker would leave the queued futures
        unresolved until every client times out; fail them fast
        instead."""
        if drain and not self._worker.is_alive():
            drain = False
        with self._cv:
            self._closed = True
            if not drain:
                pending = list(self._q)
                self._q.clear()
                for r in pending:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(
                            RuntimeError("server shutting down"))
            self._cv.notify_all()
        self._worker.join(timeout=30)
