"""Tracing spans: the port's copy of the tracer in
``avenir_tpu/core/obs.py``.

``with get_tracer().span("stage", **attrs):`` records a nested span on
the monotonic clock, parented to the innermost open span of its thread
(an explicit ``parent=`` or :meth:`Tracer.adopt` carries parentage to a
worker thread).  Finished spans land in a bounded ring buffer and export
as JSON lines or as Chrome/Perfetto ``trace_event`` JSON (``--trace
out.json`` on the CLI; open it in ``chrome://tracing`` or
https://ui.perfetto.dev).  Span names are the reference's, so one trace
reader serves both packages.

The global tracer starts disabled, and ``span()`` then returns a shared
no-op context manager: one attribute check on the hot path.

Config surface:

- ``obs.trace.enable``       -- enable the global tracer (default false;
  ``--trace <out.json>`` turns it on and exports at exit)
- ``obs.trace.buffer.spans`` -- ring-buffer capacity in records (default
  65536; the oldest drop first)

The reference's latency histograms, metrics registry, head sampling and
telemetry exporters are not ported.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

KEY_TRACE_ENABLE = "obs.trace.enable"
KEY_TRACE_BUFFER = "obs.trace.buffer.spans"

DEFAULT_BUFFER_SPANS = 1 << 16


# ---------------------------------------------------------------------------
# trace context (causal request identity)
# ---------------------------------------------------------------------------

class TraceContext:
    """One request's causal identity: the ``trace_id`` shared by every
    span of the request, its root ``span_id``, and whether it is
    sampled.  ``span(..., ctx=...)`` and :meth:`Tracer.adopt` join spans
    to it."""

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
                 buffer_spans: int = DEFAULT_BUFFER_SPANS):
        self.enabled = bool(enabled)
        self._buf: deque = deque(maxlen=max(int(buffer_spans), 1))
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
            self._buf.append(rec)
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

    # -- inspection --------------------------------------------------------
    def records(self) -> List[object]:
        with self._lock:
            return list(self._buf)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        return [r for r in self.records() if isinstance(r, Span)
                and (name is None or r.name == name)]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._active = 0
            self._total = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": self.enabled, "active_spans": self._active,
                    "spans_recorded": self._total,
                    "buffered": len(self._buf),
                    "buffer_spans": self._buf.maxlen}

    # -- exporters ---------------------------------------------------------
    def export_chrome_trace(self, path: str) -> int:
        """Write the buffer as Chrome ``trace_event`` JSON (complete "X"
        events + counter "C" events + thread-name metadata), loadable in
        ``chrome://tracing`` / Perfetto.  Returns the event count."""
        recs = self.records()
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
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
        return len(events)


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
    return tracer


def configure(enabled: Optional[bool] = None,
              buffer_spans: Optional[int] = None) -> Tracer:
    """Reconfigure the global tracer IN PLACE (every call site that
    already fetched it sees the change)."""
    tr = _GLOBAL_TRACER
    with tr._lock:
        if buffer_spans is not None and int(buffer_spans) != tr._buf.maxlen:
            tr._buf = deque(tr._buf, maxlen=max(int(buffer_spans), 1))
        if enabled is not None:
            tr.enabled = bool(enabled)
    return tr


def configure_from_config(config, force_enable: bool = False) -> Tracer:
    """Apply the ``obs.*`` properties surface to the global tracer."""
    return configure(
        enabled=force_enable or config.get_boolean(KEY_TRACE_ENABLE, False),
        buffer_spans=config.get_int(KEY_TRACE_BUFFER, DEFAULT_BUFFER_SPANS))


def traced_run(fn: Callable) -> Callable:
    """Decorator for job drivers' ``run()``: wraps the call in one
    top-level ``job:<ClassName>`` span (a no-op while tracing is
    disabled)."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        tracer = _GLOBAL_TRACER
        if not tracer.enabled:
            return fn(self, *args, **kwargs)
        with tracer.span("job:" + type(self).__name__):
            return fn(self, *args, **kwargs)
    run.__obs_traced__ = True
    return run
