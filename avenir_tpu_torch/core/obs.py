"""Unified tracing + timing metrics: spans, histograms, exporters.

The reference's only driver-visible metric channel is Hadoop counters
(``core.metrics.Counters``) — integer-only, no notion of *where* a slow
job spent its time.  This module adds the two missing representations,
following the Clipper/INFaaS premise that per-stage latency visibility is
the substrate batching and admission decisions ride on:

- **Spans** (:class:`Tracer`): ``with tracer.span("stage", **attrs):``
  produces nested, monotonic-clock span records with per-thread
  parenting (an explicit ``parent=`` or :meth:`Tracer.adopt` carries
  parentage across worker threads).  Finished records land in a bounded
  in-memory ring buffer and export to JSON-lines or the Chrome/Perfetto
  ``trace_event`` format (``--trace out.json`` on the CLI; open in
  ``chrome://tracing`` or https://ui.perfetto.dev).
- **Histograms** (:class:`LatencyHistogram`): fixed log-spaced bucket
  boundaries (mergeable across instances/threads) with p50/p90/p95/p99
  quantile estimation by log-linear interpolation inside the bucket.
- **Registry** (:class:`Metrics`): counters + named histograms + gauges
  behind one ``snapshot()`` — the job/serving stats surface.

Pay-for-what-you-use: the module-level tracer starts DISABLED and
``span()`` then returns a shared no-op context manager — a single
attribute check on the hot path (bench.py ``obs_overhead_pct`` bounds the
disabled-mode cost at < 2% of the NB and serving hot paths).

Config surface (the .properties files every job loads):

- ``obs.trace.enable``       — enable the global tracer (default false;
  the CLI ``--trace <out.json>`` flag forces it on and exports on exit)
- ``obs.trace.buffer.spans`` — ring-buffer capacity in records
  (default 65536; oldest records drop first)
- ``obs.histogram.buckets``  — log buckets across the 1µs..100s span
  (default 96, i.e. 12/decade — ~21% worst-case quantile ratio error)
- ``obs.sample.rate``        — fraction of wire requests that get their
  per-request causal trace recorded while tracing is enabled (default
  1.0; Dapper-style head sampling — errors/shed/poison requests are
  always sampled retroactively at response time)

Causal request tracing (the Dapper shape): every wire request carries a
:class:`TraceContext` — a ``trace_id`` (client-supplied or generated),
the request's pre-allocated root ``span_id``, and the head-sampling
decision.  The context travels WITH the request object across thread
boundaries (frontend I/O shard -> router -> replica batcher worker);
spans created with ``span(..., ctx=ctx)`` parent to the context's root
and stamp its ``trace`` attr, and :meth:`Tracer.adopt` accepts a context
so a worker thread's whole span tree joins the trace.  Micro-batch
fan-in is linked explicitly: the shared ``serve.batch`` span records its
member requests' span ids and each member's ``serve.score`` span records
the batch span id (see serve/batcher.py).
"""

from __future__ import annotations

import bisect
import functools
import gc
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from .metrics import Counters

KEY_TRACE_ENABLE = "obs.trace.enable"
KEY_TRACE_BUFFER = "obs.trace.buffer.spans"
KEY_HIST_BUCKETS = "obs.histogram.buckets"
KEY_SAMPLE_RATE = "obs.sample.rate"

DEFAULT_BUFFER_SPANS = 1 << 16
DEFAULT_HIST_BUCKETS = 96
DEFAULT_SAMPLE_RATE = 1.0
HIST_LO_SEC = 1e-6            # smallest resolvable latency bucket edge
HIST_HI_SEC = 100.0           # largest; beyond lands in the overflow bucket


# ---------------------------------------------------------------------------
# trace context (causal request identity)
# ---------------------------------------------------------------------------

class TraceContext:
    """One request's causal identity: the ``trace_id`` shared by every
    span of the request, its pre-allocated root ``span_id`` (so fan-in
    spans can reference the request before its root span is recorded —
    root spans are recorded RETROACTIVELY at response time), and the
    head-sampling decision.  ``sampled`` may be flipped True at response
    time (errors/shed/poison are always sampled)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: Optional[int],
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, span={self.span_id}, "
                f"sampled={self.sampled})")


#: sentinel: this span did not change the thread's current trace id
_NO_RESTORE = object()


# ---------------------------------------------------------------------------
# span records
# ---------------------------------------------------------------------------

class Span:
    """One finished span: [t0_ns, t0_ns + dur_ns) on thread ``tid``."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "thread",
                 "t0_ns", "dur_ns", "attrs")

    def __init__(self, name, span_id, parent_id, tid, thread, t0_ns,
                 dur_ns, attrs):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.thread = thread
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.attrs = attrs

    def overlaps(self, other: "Span") -> bool:
        return (self.t0_ns < other.t0_ns + other.dur_ns
                and other.t0_ns < self.t0_ns + self.dur_ns)

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur_ns={self.dur_ns})")


class Gauge:
    """One gauge sample (a Chrome-trace counter event)."""

    __slots__ = ("name", "tid", "t_ns", "value")

    def __init__(self, name, tid, t_ns, value):
        self.name = name
        self.tid = tid
        self.t_ns = t_ns
        self.value = value


class _NullSpan:
    """The shared disabled-mode span: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """A live span context manager (enabled tracer only).

    ``ctx`` joins the span to a :class:`TraceContext`: without an
    explicit ``span_id`` the span is a CHILD of the context (parent =
    ``ctx.span_id``); with one it IS the context's root span (own id =
    ``ctx.span_id``, parentage from the thread as usual).  Either way
    the thread's current trace id is set for the span's extent, so
    nested spans stamp the same ``trace`` attr."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "_t0",
                 "_ctx", "_own_id", "_trace_saved")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional[int], attrs: dict,
                 ctx: Optional[TraceContext] = None,
                 span_id: Optional[int] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.parent_id = parent
        self.span_id = None
        self._t0 = 0
        self._ctx = ctx
        self._own_id = span_id
        self._trace_saved = _NO_RESTORE

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        ctx = self._ctx
        if self.parent_id is None:
            if ctx is not None and self._own_id is None:
                self.parent_id = ctx.span_id
            else:
                self.parent_id = (stack[-1] if stack
                                  else getattr(tr._tls, "base_parent", None))
        if ctx is not None:
            self._trace_saved = getattr(tr._tls, "trace", None)
            tr._tls.trace = ctx.trace_id
            self.attrs.setdefault("trace", ctx.trace_id)
        else:
            t = getattr(tr._tls, "trace", None)
            if t is not None:
                self.attrs.setdefault("trace", t)
        self.span_id = (self._own_id if self._own_id is not None
                        else next(tr._ids))
        stack.append(self.span_id)
        with tr._lock:
            tr._active += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if self._trace_saved is not _NO_RESTORE:
            tr._tls.trace = self._trace_saved
        th = threading.current_thread()
        tr._append(Span(self.name, self.span_id, self.parent_id,
                        th.ident, th.name, self._t0, dur, self.attrs))
        with tr._lock:
            tr._active -= 1
        return False


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    Spans parent to the innermost open span OF THEIR THREAD; a worker
    thread inherits a parent either explicitly (``span(parent=...)``) or
    by calling :meth:`adopt` once with the spawning thread's
    ``current_span_id()``.
    """

    def __init__(self, enabled: bool = False,
                 buffer_spans: int = DEFAULT_BUFFER_SPANS,
                 sample_rate: float = DEFAULT_SAMPLE_RATE):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self._buf: deque = deque(maxlen=max(int(buffer_spans), 1))
        # records made where the lock may already be held (a collector
        # pass can start inside any allocation): moved into the ring
        # buffer by the next call that takes the lock
        self._handoff: deque = deque()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._active = 0
        self._total = 0
        self._epoch_ns = time.perf_counter_ns()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, parent: Optional[int] = None,
             ctx: Optional[TraceContext] = None,
             span_id: Optional[int] = None, **attrs):
        """Context manager timing the enclosed block.  Disabled-mode cost
        is one attribute check + a shared no-op object.  ``ctx`` joins
        the span to a request trace (see :class:`_SpanCtx`)."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, parent, attrs, ctx=ctx, span_id=span_id)

    def record_span(self, name: str, t0_ns: int, dur_ns: int,
                    parent: Optional[int] = None,
                    ctx: Optional[TraceContext] = None,
                    span_id: Optional[int] = None, **attrs) -> None:
        """Record an already-measured interval (e.g. queue wait computed
        from an enqueue timestamp) without a with-block.  With ``ctx``
        the span stamps the trace id and (unless ``span_id`` names it as
        the context's own root span) parents to the context's root; with
        ``span_id`` the caller owns parentage — ``parent=None`` records
        a detached root."""
        if not self.enabled:
            return
        if ctx is not None:
            attrs.setdefault("trace", ctx.trace_id)
        if parent is None and span_id is None:
            parent = (ctx.span_id if ctx is not None
                      else self.current_span_id())
        th = threading.current_thread()
        self._append(Span(name, span_id if span_id is not None
                          else next(self._ids), parent, th.ident,
                          th.name, int(t0_ns), max(int(dur_ns), 0), attrs))

    def gauge(self, name: str, value) -> None:
        """Record one sample of a numeric time series (queue depth, pad
        fraction, ...) — a Chrome-trace counter event."""
        if not self.enabled:
            return
        self._append(Gauge(name, threading.get_ident(),
                           time.perf_counter_ns(), float(value)))

    def _append(self, rec) -> None:
        # append under the lock: exporters/readers snapshot the deque by
        # iterating it, and a concurrent append during that iteration
        # would raise "deque mutated during iteration"
        with self._lock:
            self._drain()
            self._buf.append(rec)
            self._total += 1

    def _drain(self) -> None:
        """Move handed-off records into the ring buffer (lock held)."""
        while self._handoff:
            self._buf.append(self._handoff.popleft())
            self._total += 1

    # -- thread parenting --------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span_id(self) -> Optional[int]:
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1]
        return getattr(self._tls, "base_parent", None)

    def adopt(self, parent, trace: Optional[str] = None) -> None:
        """Seed this thread's root parent: subsequent top-level spans on
        the calling thread parent to ``parent``.  Accepts either a span
        id (optionally with an explicit ``trace`` id so the worker's
        spans join the caller's trace) or a whole :class:`TraceContext`
        — adopt-by-context, the cross-thread half of causal request
        tracing."""
        if isinstance(parent, TraceContext):
            self._tls.base_parent = parent.span_id
            self._tls.trace = parent.trace_id
            return
        self._tls.base_parent = parent
        if trace is not None:
            self._tls.trace = trace

    def current_trace_id(self) -> Optional[str]:
        """The calling thread's current trace id (an enclosing
        ctx-joined span or an adopt-by-context), or None."""
        return getattr(self._tls, "trace", None)

    def current_context(self) -> Optional[TraceContext]:
        """The calling thread's (trace id, innermost span id) as a
        TraceContext — the handle to pass a worker thread's ``adopt``.
        None when no trace is active on this thread."""
        t = getattr(self._tls, "trace", None)
        if t is None:
            return None
        return TraceContext(t, self.current_span_id(), True)

    def sample(self) -> bool:
        """One head-sampling decision at ``obs.sample.rate`` (True only
        while the tracer is enabled)."""
        if not self.enabled:
            return False
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        return rate > 0.0 and random.random() < rate

    # -- inspection --------------------------------------------------------
    def records(self) -> List[object]:
        with self._lock:
            self._drain()
            return list(self._buf)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        return [r for r in self.records() if isinstance(r, Span)
                and (name is None or r.name == name)]

    def span_summary(self, name: str) -> Dict[str, float]:
        """Aggregate duration stats for spans named ``name`` — the quick
        way to compare per-chunk host costs (e.g. ``ingest.parse`` vs
        ``ingest.h2d`` across two pipeline configurations) without
        exporting a full trace."""
        spans = self.spans(name)
        total_ns = sum(s.dur_ns for s in spans)
        n = len(spans)
        return {"count": n, "total_ms": total_ns / 1e6,
                "mean_ms": (total_ns / n / 1e6) if n else 0.0}

    def span_summaries(self) -> Dict[str, Dict[str, float]]:
        """``span_summary`` for every span name currently buffered — the
        shape the periodic telemetry exporter ships (count + total/mean
        ms per name, both mergeable across snapshots by count-weighted
        sum)."""
        agg: Dict[str, list] = {}
        for r in self.records():
            if isinstance(r, Span):
                e = agg.setdefault(r.name, [0, 0])
                e[0] += 1
                e[1] += r.dur_ns
        return {k: {"count": c, "total_ms": t / 1e6,
                    "mean_ms": (t / c / 1e6) if c else 0.0}
                for k, (c, t) in sorted(agg.items())}

    def records_since(self, since_total: int):
        """``(new records, new total, dropped)`` — every record appended
        after the ``since_total``-th, for incremental (tail-follow)
        exporters.  ``dropped`` counts records that arrived but already
        rotated out of the ring buffer between calls (the flusher's
        interval bounds it)."""
        with self._lock:
            self._drain()
            new = self._total - since_total
            if new <= 0:
                return [], self._total, 0
            buf = list(self._buf)
            have = min(new, len(buf))
            return buf[len(buf) - have:], self._total, new - have

    def clear(self) -> None:
        with self._lock:
            self._handoff.clear()
            self._buf.clear()
            self._active = 0
            self._total = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            self._drain()
            return {"enabled": self.enabled, "active_spans": self._active,
                    "spans_recorded": self._total,
                    "buffered": len(self._buf),
                    "buffer_spans": self._buf.maxlen}

    def wall_epoch_unix_ns(self) -> int:
        """The tracer's perf-counter epoch expressed on the Unix wall
        clock (ns).  Every exported ``t0_ns``/``t_ns`` is relative to
        the construction-time ``perf_counter_ns`` epoch, which is
        meaningless outside this process — the fleet trace stitcher
        (``fleetobs.stitch``) offsets each process's records by its
        published anchor to place N processes on ONE wall-clock
        timeline.  Re-derived per call (wall clock minus elapsed
        monotonic), so it is stable to perf-counter drift but moves
        with NTP steps; millisecond-grade cross-process alignment is
        the design point, the intra-process ordering stays exact."""
        return time.time_ns() - (time.perf_counter_ns() - self._epoch_ns)

    # -- exporters ---------------------------------------------------------
    def record_dict(self, r) -> dict:
        """One record as the JSONL-exporter dict (shared by the one-shot
        exporter and the periodic incremental trace flusher)."""
        if isinstance(r, Span):
            return {"type": "span", "name": r.name, "id": r.span_id,
                    "parent": r.parent_id, "thread": r.thread,
                    "t0_ns": r.t0_ns - self._epoch_ns,
                    "dur_ns": r.dur_ns, "attrs": r.attrs}
        return {"type": "gauge", "name": r.name,
                "t_ns": r.t_ns - self._epoch_ns, "value": r.value}

    def export_jsonl(self, path: str) -> int:
        """One JSON object per buffered record; returns the line count."""
        recs = self.records()
        with open(path, "w") as fh:
            for r in recs:
                fh.write(json.dumps(self.record_dict(r)) + "\n")
        return len(recs)

    def export_chrome_trace(self, path: str) -> int:
        """Write the buffer as Chrome ``trace_event`` JSON (complete "X"
        events + counter "C" events + thread-name metadata), loadable in
        ``chrome://tracing`` / Perfetto.  Returns the event count.

        ``baseTimeNanoseconds`` is the wall-clock anchor of the events'
        ``ts`` (``wall_epoch_unix_ns``): ``base + ts * 1000`` is an
        event's Unix time in ns.  ``torch.profiler`` writes its traces
        (``--profile-dir``) with the same key and meaning, so the two
        files of one run lie on one timeline once each is shifted by its
        own base."""
        recs = self.records()
        base_ns = self.wall_epoch_unix_ns()
        pid = os.getpid()
        events: List[dict] = []
        tid_map: Dict[int, int] = {}

        def tid_of(ident, name=None):
            t = tid_map.get(ident)
            if t is None:
                t = tid_map[ident] = len(tid_map) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": t,
                               "args": {"name": name or f"thread-{ident}"}})
            return t

        for r in recs:
            if isinstance(r, Span):
                ev = {"name": r.name, "cat": "avenir", "ph": "X",
                      "ts": (r.t0_ns - self._epoch_ns) / 1000.0,
                      "dur": r.dur_ns / 1000.0,
                      "pid": pid, "tid": tid_of(r.tid, r.thread),
                      "args": {"id": r.span_id, "parent": r.parent_id,
                               **r.attrs}}
            else:
                ev = {"name": r.name, "cat": "avenir", "ph": "C",
                      "ts": (r.t_ns - self._epoch_ns) / 1000.0,
                      "pid": pid, "args": {"value": r.value}}
            events.append(ev)
        events.sort(key=lambda e: e.get("ts", -1.0))
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base_ns}, fh)
        return len(events)


# ---------------------------------------------------------------------------
# latency histograms
# ---------------------------------------------------------------------------

def _log_bounds(n_buckets: int, lo: float, hi: float) -> List[float]:
    ratio = (hi / lo) ** (1.0 / n_buckets)
    return [lo * ratio ** i for i in range(n_buckets + 1)]


def quantile_from_counts(bounds: Sequence[float], counts: Sequence[int],
                         q: float, vmin: Optional[float] = None,
                         vmax: Optional[float] = None) -> Optional[float]:
    """Quantile estimate (seconds) from raw bucket counts against a
    bound ladder — the module-level form of
    :meth:`LatencyHistogram.quantile`, usable on DIFFED counts (the SLO
    monitor's rolling windows subtract two cumulative snapshots, so the
    window's distribution exists only as a counts list, never as a live
    histogram instance)."""
    n = sum(counts)
    if n == 0:
        return None
    if vmin is None or vmax is None:
        # the observed extrema are unknown (diffed counts): bound them by
        # the occupied buckets' edges, so a tiny window's quantile lands
        # in its own bucket instead of collapsing to bounds[0] (a 1-
        # request window must still be able to violate a latency SLO)
        occupied = [i for i, c in enumerate(counts) if c]
        lo_i, hi_i = occupied[0], occupied[-1]
        if vmin is None:
            vmin = bounds[lo_i - 1] if lo_i >= 1 else bounds[0]
        if vmax is None:
            vmax = bounds[hi_i] if hi_i < len(bounds) else bounds[-1]
    target = max(q, 0.0) * n
    if target <= 1.0:
        return vmin
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo_e = bounds[i - 1] if i >= 1 else vmin
            hi_e = bounds[i] if i < len(bounds) else vmax
            lo_e = max(lo_e, vmin)
            hi_e = min(hi_e, vmax)
            if hi_e <= lo_e or lo_e <= 0:
                return min(max(hi_e, vmin), vmax)
            frac = (target - cum) / c
            return lo_e * (hi_e / lo_e) ** frac
        cum += c
    return vmax


class LatencyHistogram:
    """Fixed-boundary log-bucketed latency histogram (seconds).

    Boundaries are a geometric ladder ``lo..hi`` shared by every instance
    constructed with the same parameters, so histograms MERGE exactly
    (bucket-wise add) across threads, models, or processes.  Quantiles
    are estimated by locating the target rank's bucket and log-linearly
    interpolating between its edges, clamped to the observed min/max —
    worst-case ratio error is one bucket's growth factor
    (~21% at the default 12 buckets/decade, typically far less).

    Exemplars: ``record(seconds, trace_id=...)`` retains the LAST sampled
    trace id per bucket (with its exact value and epoch timestamp), so a
    bad tail quantile links directly to a trace to open — surfaced as
    OpenMetrics exemplars in the Prometheus exposition
    (``core.telemetry.prometheus_text``) and as ``p99_exemplar`` in
    :meth:`snapshot`.  Exemplars merge latest-timestamp-wins.
    """

    __slots__ = ("bounds", "counts", "n", "total", "vmin", "vmax",
                 "exemplars", "_lock")

    def __init__(self, n_buckets: int = DEFAULT_HIST_BUCKETS,
                 lo: float = HIST_LO_SEC, hi: float = HIST_HI_SEC):
        if n_buckets < 1 or not (0 < lo < hi):
            raise ValueError(f"bad histogram shape: {n_buckets}, {lo}, {hi}")
        self.bounds = _log_bounds(int(n_buckets), float(lo), float(hi))
        self.counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        # bucket index -> (trace_id, value seconds, epoch ts): the last
        # sampled request that landed in the bucket
        self.exemplars: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def record(self, seconds: float, trace_id: Optional[str] = None,
               ts: Optional[float] = None) -> None:
        """Record one sample; ``ts`` overrides the exemplar's epoch
        stamp (deterministic replay — the split-invariance verifier
        feeds explicit stamps so merge properties are exact, and a
        cross-process replayer can preserve original times)."""
        s = float(seconds)
        i = bisect.bisect_right(self.bounds, s)
        with self._lock:
            self.counts[i] += 1
            self.n += 1
            self.total += s
            if s < self.vmin:
                self.vmin = s
            if s > self.vmax:
                self.vmax = s
            if trace_id is not None:
                e = (str(trace_id), s,
                     time.time() if ts is None else float(ts))
                cur = self.exemplars.get(i)
                # SAME retention rule as merge ((ts, trace_id, value)
                # max): a single histogram and a sharded-then-merged
                # one agree exactly even when a replayer stamps ts out
                # of order — the merge==single-run property is exact
                if cur is None or (e[2], e[0], e[1]) > (cur[2], cur[0],
                                                        cur[1]):
                    self.exemplars[i] = e

    def record_ns(self, ns: int, trace_id: Optional[str] = None) -> None:
        self.record(ns * 1e-9, trace_id=trace_id)

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.n = 0
            self.total = 0.0
            self.vmin = float("inf")
            self.vmax = float("-inf")
            self.exemplars = {}

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram (boundaries must match)."""
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket boundaries")
        counts, n, total, vmin, vmax = other._state()
        ex = other._exemplar_state()
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.n += n
            self.total += total
            self.vmin = min(self.vmin, vmin)
            self.vmax = max(self.vmax, vmax)
            for i, e in ex.items():
                cur = self.exemplars.get(i)
                # (ts, trace_id, value) ordering: exact-ts ties break on
                # content, not merge side, so merge stays commutative
                # (the split-invariance verifier's property)
                if cur is None or (e[2], str(e[0]), e[1]) > (cur[2],
                                                             str(cur[0]),
                                                             cur[1]):
                    self.exemplars[i] = e
        return self

    def _state(self):
        with self._lock:
            return list(self.counts), self.n, self.total, self.vmin, self.vmax

    def _exemplar_state(self) -> Dict[int, tuple]:
        with self._lock:
            return dict(self.exemplars)

    # -- quantiles ---------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        return self.quantiles([q])[0]

    def quantiles(self, qs: Sequence[float]) -> List[Optional[float]]:
        """Estimate several quantiles from ONE consistent snapshot."""
        counts, n, _total, vmin, vmax = self._state()
        return [self._quantile_from(counts, n, vmin, vmax, q) for q in qs]

    def _quantile_from(self, counts, n, vmin, vmax, q: float):
        if n == 0:
            return None
        return quantile_from_counts(self.bounds, counts, q, vmin, vmax)

    # -- surfaces ----------------------------------------------------------
    def percentiles_ms(self) -> dict:
        """The serving stats latency dict (field names byte-compatible
        with the original hand-rolled sample-sort implementation)."""
        counts, n, total, vmin, vmax = self._state()
        if n == 0:
            return {"p50": None, "p95": None, "p99": None, "n": 0}

        def pct(q):
            return round(
                self._quantile_from(counts, n, vmin, vmax, q) * 1000.0, 3)

        return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
                "mean": round(total / n * 1000.0, 3), "n": n}

    def snapshot(self) -> dict:
        """Full histogram state for the stats surface / JSON export."""
        counts, n, total, vmin, vmax = self._state()
        if n == 0:
            return {"n": 0}

        def pct(q):
            return round(
                self._quantile_from(counts, n, vmin, vmax, q) * 1000.0, 4)

        out = {"n": n,
               "mean_ms": round(total / n * 1000.0, 4),
               "min_ms": round(vmin * 1000.0, 4),
               "max_ms": round(vmax * 1000.0, 4),
               "p50_ms": pct(0.50), "p90_ms": pct(0.90),
               "p95_ms": pct(0.95), "p99_ms": pct(0.99)}
        ex = self.exemplar_near(0.99)
        if ex is not None:
            out["p99_exemplar"] = ex
        return out

    def exemplar_near(self, q: float = 0.99) -> Optional[dict]:
        """The retained exemplar closest at-or-below the bucket holding
        the ``q``-quantile rank (nearest above as a fallback) — the
        "p99 is bad, open THIS trace" link in stats/health."""
        counts, n, _total, _vmin, _vmax = self._state()
        ex = self._exemplar_state()
        if n == 0 or not ex:
            return None
        target = max(q, 0.0) * n
        cum = 0
        bucket = len(counts) - 1
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                bucket = i
                break
        order = list(range(bucket, -1, -1)) + list(range(bucket + 1,
                                                         len(counts)))
        for i in order:
            e = ex.get(i)
            if e is not None:
                return {"trace_id": e[0],
                        "value_ms": round(e[1] * 1000.0, 4), "ts": e[2]}
        return None

    def state_dict(self) -> dict:
        """Mergeable raw state: sparse bucket counts + the shape params
        that prove two states share one bound ladder.  This is the form
        the telemetry exporter ships (counts ADD across processes —
        multi-host aggregation is a fold over these dicts; see
        ``core.telemetry.merge_snapshots``)."""
        counts, n, total, vmin, vmax = self._state()
        out = {"n_buckets": len(self.bounds) - 1,
               "lo": self.bounds[0], "hi": self.bounds[-1],
               "counts": {str(i): c for i, c in enumerate(counts) if c},
               "n": n, "total": total,
               "vmin": (vmin if n else None),
               "vmax": (vmax if n else None)}
        ex = self._exemplar_state()
        if ex:
            out["exemplars"] = {
                str(i): {"trace_id": t, "value": v, "ts": ts}
                for i, (t, v, ts) in sorted(ex.items())}
        return out

    @classmethod
    def from_state(cls, state: dict) -> "LatencyHistogram":
        """Rebuild a live histogram from a :meth:`state_dict` (exact
        inverse — used by snapshot consumers that want quantiles out of
        a merged multi-process state)."""
        h = cls(int(state["n_buckets"]), float(state["lo"]),
                float(state["hi"]))
        for i, c in state.get("counts", {}).items():
            h.counts[int(i)] = int(c)
        h.n = int(state.get("n", 0))
        h.total = float(state.get("total", 0.0))
        if h.n:
            h.vmin = float(state["vmin"])
            h.vmax = float(state["vmax"])
        for i, e in (state.get("exemplars") or {}).items():
            h.exemplars[int(i)] = (e["trace_id"], float(e["value"]),
                                   float(e["ts"]))
        return h


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class Metrics:
    """Counters + named latency histograms + gauges behind one snapshot.

    Extends (does not replace) :class:`core.metrics.Counters`: jobs keep
    returning Counters; a Metrics registry groups that Counters with the
    timing distributions the integer channel cannot carry.
    """

    def __init__(self, counters: Optional[Counters] = None,
                 hist_buckets: int = DEFAULT_HIST_BUCKETS):
        self.counters = counters if counters is not None else Counters()
        self.hist_buckets = int(hist_buckets)
        self._hists: Dict[str, LatencyHistogram] = {}
        self._gauges: Dict[str, tuple] = {}      # name -> (value, epoch ts)
        self._lock = threading.Lock()

    def histogram(self, name: str) -> LatencyHistogram:
        """Get-or-create the named histogram (shared boundaries)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram(self.hist_buckets)
            return h

    def set_gauge(self, name: str, value, ts: Optional[float] = None) -> None:
        """Record one gauge value, stamped with its epoch time — merging
        two snapshots keeps the LATEST sample of each gauge, so every
        set carries when it happened (``ts`` overrides for replayed or
        cross-process samples)."""
        with self._lock:
            self._gauges[name] = (float(value),
                                  float(ts) if ts is not None else time.time())

    def get_gauge(self, name: str, default=None):
        with self._lock:
            g = self._gauges.get(name)
        return g[0] if g is not None else default

    def clear(self) -> None:
        """Drop every histogram and gauge and reset the counters (test
        isolation for the process-global registry)."""
        with self._lock:
            self._hists.clear()
            self._gauges.clear()
            self.counters = Counters()

    def snapshot(self) -> dict:
        """Human-readable snapshot: quantile summaries per histogram,
        gauge values WITH their sample timestamps, and the snapshot's
        own epoch + monotonic stamps (so exported series can be
        plotted/joined — a snapshot knows *when*)."""
        with self._lock:
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        return {"ts": time.time(), "mono": time.monotonic(),
                "counters": self.counters.as_dict(),
                "histograms": {k: h.snapshot() for k, h in
                               sorted(hists.items())},
                "gauges": {k: {"value": v, "ts": t}
                           for k, (v, t) in sorted(gauges.items())}}

    def mergeable_snapshot(self) -> dict:
        """The cross-process form: raw histogram bucket states instead
        of quantile summaries, so N processes' snapshots FOLD into one
        (counters sum, buckets add, gauges latest-timestamp-wins) — see
        ``core.telemetry.merge_snapshots``."""
        with self._lock:
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        return {"ts": time.time(), "mono": time.monotonic(),
                "counters": self.counters.as_dict(),
                "hists": {k: h.state_dict() for k, h in sorted(hists.items())},
                "gauges": {k: {"value": v, "ts": t}
                           for k, (v, t) in sorted(gauges.items())}}


# ---------------------------------------------------------------------------
# global tracer + config plumbing
# ---------------------------------------------------------------------------

_GLOBAL_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled until configured)."""
    return _GLOBAL_TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = tracer
    _sync_gc_hook()
    return tracer


_gc_t0 = [0]


def _gc_hook(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: one ``host.gc`` span per generation 1 and
    2 collection, on the thread that triggered it, parented to that
    thread's open span.  A pass can start inside any allocation, also
    one made while the tracer's lock is held, so the record is handed
    off instead of appended (``Tracer._drain``).  Generation 0 runs every
    few hundred allocations and is left out: it would flood a serving
    trace's ring buffer."""
    if info.get("generation", 0) < 1:
        return
    if phase == "start":
        _gc_t0[0] = time.perf_counter_ns()
        return
    tr = _GLOBAL_TRACER
    t0 = _gc_t0[0]
    if not tr.enabled or not t0:
        return
    _gc_t0[0] = 0
    th = threading.current_thread()
    tr._handoff.append(Span(
        "host.gc", next(tr._ids), tr.current_span_id(), th.ident, th.name,
        t0, time.perf_counter_ns() - t0,
        {"generation": info["generation"],
         "collected": info.get("collected", 0)}))


def _sync_gc_hook() -> None:
    """Install the collector hook while the global tracer is enabled,
    and remove it when it is not."""
    on = _GLOBAL_TRACER.enabled
    if on and _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    elif not on and _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)


def new_trace_context(trace_id: Optional[str] = None,
                      sampled: Optional[bool] = None) -> TraceContext:
    """Mint one request's :class:`TraceContext` against the global
    tracer: a client-supplied ``trace_id`` propagates (and forces the
    sampling decision — the caller already committed to the trace, the
    Dapper propagation rule); otherwise a random 64-bit hex id is
    generated (``os.urandom`` — thread-safe, collision-free in practice)
    and head sampling applies ``obs.sample.rate``.  The root span id is
    pre-allocated from the tracer's id space so fan-in spans can
    reference the request before its retroactive root span exists."""
    tr = _GLOBAL_TRACER
    client = trace_id is not None
    if trace_id is None:
        trace_id = os.urandom(8).hex()
    if sampled is None:
        sampled = (tr.enabled and client) or tr.sample()
    return TraceContext(str(trace_id), next(tr._ids), bool(sampled))


def configure(enabled: Optional[bool] = None,
              buffer_spans: Optional[int] = None,
              sample_rate: Optional[float] = None) -> Tracer:
    """Reconfigure the global tracer IN PLACE (every call site that
    already fetched it sees the change)."""
    tr = _GLOBAL_TRACER
    with tr._lock:
        if buffer_spans is not None and int(buffer_spans) != tr._buf.maxlen:
            tr._buf = deque(tr._buf, maxlen=max(int(buffer_spans), 1))
        if enabled is not None:
            tr.enabled = bool(enabled)
        if sample_rate is not None:
            tr.sample_rate = float(sample_rate)
    _sync_gc_hook()
    return tr


def configure_from_config(config, force_enable: bool = False) -> Tracer:
    """Apply the ``obs.*`` properties surface to the global tracer."""
    return configure(
        enabled=force_enable or config.get_boolean(KEY_TRACE_ENABLE, False),
        buffer_spans=config.get_int(KEY_TRACE_BUFFER, DEFAULT_BUFFER_SPANS),
        sample_rate=config.get_float(KEY_SAMPLE_RATE, DEFAULT_SAMPLE_RATE))


def histogram_buckets_from_config(config) -> int:
    n = config.get_int(KEY_HIST_BUCKETS, DEFAULT_HIST_BUCKETS)
    if n < 1:
        raise ValueError(f"{KEY_HIST_BUCKETS} must be positive: {n}")
    return n


def record_prepare(t0_ns: int) -> None:
    """Record ``cli.prepare``, a job's set-up before its ``run`` (config,
    obs and resilience settings, mesh, the job's constructor), from
    ``t0_ns`` to now, once the tracer is configured.  It becomes the
    first child of the ``job:<ClassName>`` span that the next
    :func:`traced_run` opens on this thread, whose id it reserves."""
    tr = _GLOBAL_TRACER
    if not tr.enabled:
        return
    job_id = next(tr._ids)
    tr.record_span("cli.prepare", t0_ns, time.perf_counter_ns() - t0_ns,
                   parent=job_id)
    tr._tls.job_span_id = job_id


def traced_run(fn: Callable) -> Callable:
    """Decorator for job drivers' ``run()``: wraps the call in one
    top-level ``job:<ClassName>`` span (a no-op while tracing is
    disabled), under the id :func:`record_prepare` reserved, if any.
    ``tests/test_obs_coverage.py`` asserts every registered driver
    carries it, so new drivers cannot silently opt out."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        tracer = _GLOBAL_TRACER
        if not tracer.enabled:
            return fn(self, *args, **kwargs)
        job_id = getattr(tracer._tls, "job_span_id", None)
        tracer._tls.job_span_id = None
        with tracer.span("job:" + type(self).__name__, span_id=job_id):
            return fn(self, *args, **kwargs)
    run.__obs_traced__ = True
    return run
