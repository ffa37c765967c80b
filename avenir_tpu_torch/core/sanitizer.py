"""Runtime concurrency sanitizer: instrumented locks + lock-order graph.

The static lock-discipline rule (``avenir_tpu.analysis``) proves every
mutation holds *a* lock; this module checks the property static analysis
cannot — that the locks are acquired in a **consistent global order**,
the condition Savage et al.'s Eraser (TOCS 1997) tracks for locksets and
classical deadlock avoidance requires for ordering.  It is the runtime
twin of the static rule:

- :func:`make_lock` / :func:`make_rlock` / :func:`make_condition` are
  drop-in factories the concurrency-heavy classes use instead of bare
  ``threading.Lock()``.  **Disabled (the default) they return the plain
  primitive — zero overhead, zero behavior change.**  Enabled
  (``sanitize.locks=true``, or :func:`enable` in a test fixture,
  *before* the objects are constructed) they return a
  :class:`TrackedLock` that records, per thread, the acquisition order:
  acquiring ``B`` while holding ``A`` adds the edge ``A -> B`` to a
  process-global lock-order graph.
- At teardown, :func:`assert_no_cycles` fails the run when the graph
  contains a cycle — two threads that ever interleave those acquisition
  chains can deadlock, even if this run got lucky.  The chaos soak and
  the pool/frontend hammers run under exactly this check.
- Every release records the **held duration** into the telemetry
  registry (histogram ``sanitizer.lock.held.<name>``), so lock
  contention shows up in the same mergeable snapshots / Prometheus
  exposition as every other latency distribution.

Config surface (README "Static analysis & sanitizers"):

- ``sanitize.locks`` — ``true`` enables the tracked-lock factories for
  locks constructed AFTER configuration (the serve/CLI entry points
  configure before building anything).  Default ``false``.

Names are class-level (every ``MicroBatcher`` condition is
``serve.batcher.cv``): the graph checks the ORDERING DISCIPLINE between
lock classes, which is what a reviewer can reason about.  Acquiring two
distinct instances of the same name records a self-edge — ordering two
siblings by whichever the thread grabbed first is itself a deadlock
recipe (swap the order in another thread and they interlock), so it
fails like any other cycle.  Reentrant acquisition of the SAME RLock
instance is recognized and skipped.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

KEY_SANITIZE_LOCKS = "sanitize.locks"

#: histogram name prefix in the telemetry registry
HELD_HIST_PREFIX = "sanitizer.lock.held."


class LockOrderCycle(RuntimeError):
    """The lock-order graph contains a cycle: some interleaving of the
    recorded acquisition chains can deadlock."""


class _State:
    """Process-global sanitizer state: the order graph + per-thread held
    stacks.  The internal lock is a PLAIN lock, acquired only at
    graph-edge bookkeeping (leaf level — never while taking a user
    lock), so the sanitizer cannot deadlock the code it watches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # (holder name, acquired name) -> {"count", "thread"}
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.names: Dict[str, int] = {}       # name -> acquisitions
        self.acquisitions = 0

    def held_stack(self) -> list:
        stack = getattr(self._tls, "held", None)
        if stack is None:
            stack = self._tls.held = []
        return stack

    def on_acquired(self, lock_id: int, name: str) -> None:
        if getattr(self._tls, "busy", False):
            return      # bookkeeping re-entered (histogram record path)
        stack = self.held_stack()
        new_edges = []
        for held_id, held_name, _t0 in stack:
            if held_id == lock_id:
                continue                      # reentrant RLock acquire
            new_edges.append((held_name, name))
        stack.append((lock_id, name, time.monotonic()))
        with self._lock:
            self.acquisitions += 1
            self.names[name] = self.names.get(name, 0) + 1
            for edge in new_edges:
                info = self.edges.get(edge)
                if info is None:
                    self.edges[edge] = {
                        "count": 1,
                        "thread": threading.current_thread().name}
                else:
                    info["count"] += 1

    def on_released(self, lock_id: int, name: str) -> Optional[float]:
        """Pop the held-stack entry and return the held duration (no
        I/O here: the caller records it AFTER the inner lock is
        released, so histogram bookkeeping never extends the user
        lock's critical section)."""
        if getattr(self._tls, "busy", False):
            return None
        stack = self.held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == lock_id and stack[i][1] == name:
                _lid, _n, t0 = stack.pop(i)
                return time.monotonic() - t0
        return None

    def record_held(self, name: str, dur: float) -> None:
        # re-entrancy guard: the registry histogram's own lock (or
        # anything it touches) must not feed back into the order graph
        # / duration recording
        self._tls.busy = True
        try:
            from . import telemetry
            telemetry.get_metrics().histogram(
                HELD_HIST_PREFIX + name).record(dur)
        except Exception:                       # noqa: BLE001
            pass          # metrics must never break a release path
        finally:
            self._tls.busy = False

    # -- the order graph ---------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Every distinct cycle in the lock-order graph, as node paths
        (``[a, b, a]``).  Self-edges (two same-named instances nested)
        are one-node cycles."""
        with self._lock:
            adj: Dict[str, List[str]] = {}
            for (a, b), _info in sorted(self.edges.items()):
                adj.setdefault(a, []).append(b)
        out: List[List[str]] = []
        seen_cycles = set()
        for start in sorted(adj):
            # DFS from each node; report back edges to the current path
            path: List[str] = []
            on_path: Dict[str, int] = {}

            def dfs(node: str):
                if node in on_path:
                    cyc = path[on_path[node]:] + [node]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                    return
                on_path[node] = len(path)
                path.append(node)
                for nxt in adj.get(node, ()):
                    dfs(nxt)
                path.pop()
                del on_path[node]

            dfs(start)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"locks": dict(sorted(self.names.items())),
                    "acquisitions": self.acquisitions,
                    "edges": {f"{a} -> {b}": dict(info)
                              for (a, b), info in sorted(
                                  self.edges.items())}}


class TrackedLock:
    """A named lock wrapper feeding the order graph + held-duration
    histograms.  API-compatible with ``threading.Lock`` (and, with an
    RLock inner, with ``threading.RLock``), including the
    ``_is_owned``/``_release_save``/``_acquire_restore`` protocol
    ``threading.Condition`` probes for — so a sanitized condition keeps
    the REENTRANT semantics of the stock ``Condition()`` default.

    Bookkeeping tracks the OUTERMOST hold only (a per-thread depth
    counter): reentrant RLock acquires neither re-enter the order graph
    nor split the held-duration measurement."""

    def __init__(self, name: str, state: _State, inner=None):
        self.name = name
        self._state = state
        self._inner = threading.Lock() if inner is None else inner
        self._depths = threading.local()

    def _depth(self) -> int:
        return getattr(self._depths, "d", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            d = self._depth()
            self._depths.d = d + 1
            if d == 0:
                self._state.on_acquired(id(self), self.name)
        return ok

    def release(self) -> None:
        d = self._depth()
        self._inner.release()     # a non-owner release raises HERE,
        #                           before any bookkeeping mutates
        self._depths.d = max(d - 1, 0)
        if d == 1:
            # held-duration export happens AFTER the release: waiters
            # are already unblocked, and the measured hold stays honest
            dur = self._state.on_released(id(self), self.name)
            if dur is not None:
                self._state.record_held(self.name, dur)

    def locked(self) -> bool:
        return self._inner.locked()

    # -- the Condition lock protocol ---------------------------------------
    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # plain-Lock fallback mirrors threading.Condition's own probe
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        """Condition.wait: fully release (recursive holds included)."""
        d = self._depth()
        if hasattr(self._inner, "_release_save"):
            saved = self._inner._release_save()
        else:
            self._inner.release()
            saved = None
        self._depths.d = 0
        if d > 0:
            dur = self._state.on_released(id(self), self.name)
            if dur is not None:
                self._state.record_held(self.name, dur)
        return (saved, d)

    def _acquire_restore(self, token) -> None:
        saved, d = token
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(saved)
        else:
            self._inner.acquire()
        self._depths.d = d
        if d > 0:
            self._state.on_acquired(id(self), self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"TrackedLock({self.name!r})"


# ---------------------------------------------------------------------------
# the module surface: factories + lifecycle
# ---------------------------------------------------------------------------

_STATE: Optional[_State] = None


def enabled() -> bool:
    return _STATE is not None


def enable() -> _State:
    """Turn the sanitizer on with a FRESH graph (locks constructed from
    now on are tracked; previously constructed ones stay plain)."""
    global _STATE
    _STATE = _State()
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def get_state() -> Optional[_State]:
    return _STATE


def configure_from_config(config) -> None:
    """Apply ``sanitize.locks`` (called by the CLI entry points next to
    the resilience configure, BEFORE any engine/server construction)."""
    want = config.get_boolean(KEY_SANITIZE_LOCKS, False)
    if want and not enabled():
        enable()
    elif not want and enabled():
        disable()


def make_lock(name: str):
    """A mutex for one named role: plain ``threading.Lock`` when the
    sanitizer is off, a :class:`TrackedLock` when on."""
    state = _STATE
    if state is None:
        return threading.Lock()
    return TrackedLock(name, state)


def make_rlock(name: str):
    state = _STATE
    if state is None:
        return threading.RLock()
    return TrackedLock(name, state, inner=threading.RLock())


def make_condition(name: str):
    """A condition variable whose underlying mutex is tracked.  The
    inner lock is an RLock, matching ``threading.Condition()``'s
    default — sanitized runs keep production's reentrancy semantics
    instead of introducing a deadlock of their own."""
    state = _STATE
    if state is None:
        return threading.Condition()
    return threading.Condition(
        TrackedLock(name, state, inner=threading.RLock()))


def cycles() -> List[List[str]]:
    state = _STATE
    return state.cycles() if state is not None else []


def stats() -> dict:
    state = _STATE
    return state.stats() if state is not None else {}


def assert_no_cycles(disable_after: bool = False) -> dict:
    """The teardown check: raise :class:`LockOrderCycle` naming every
    cycle in the recorded order graph; returns the sanitizer stats when
    clean.  ``disable_after`` turns the sanitizer off either way (test
    fixtures)."""
    state = _STATE
    if state is None:
        return {}
    try:
        found = state.cycles()
        if found:
            desc = "; ".join(" -> ".join(c) for c in found)
            raise LockOrderCycle(
                f"lock-order cycle(s) detected (potential deadlock): "
                f"{desc}.  Edges: {state.stats()['edges']}")
        return state.stats()
    finally:
        if disable_after:
            disable()
