"""Ordered parallel parse pool: the port's copy of
``avenir_tpu/core/parparse.py``.

The cold pipeline is bound by the host's parse.  This module fans the
per-chunk native encode calls, which release the GIL for their whole
duration, across a small worker pool and hands the results back strictly
in submission (chunk-index) order, so the serial consumer downstream
(vocabulary merge, salvage, quarantine, checkpoint tokens) sees exactly
the byte-stream order of the serial scan, and vocabulary discovery order
is the one-shot encode's by construction.

Workers run only the supplied function over its payload (no shared
Python state); producing payloads (``next`` on the source iterator: file
reads, fault injection) and consuming results both happen on the
caller's thread.  A bounded in-flight window (2 x threads) caps the
buffered chunks, as ``drive_prefetched``'s queue depth does.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Callable, Iterable, Iterator

#: worker threads for the parallel native parse: 1 = serial (the
#: default), 0 = auto (min(8, cores)), N = exactly N
KEY_PARSE_THREADS = "ingest.parse.threads"


def parse_threads_from_config(cfg) -> int:
    """Resolve ``ingest.parse.threads`` to a concrete worker count."""
    n = cfg.get_int(KEY_PARSE_THREADS, 1)
    if n < 0:
        raise ValueError(f"{KEY_PARSE_THREADS} must be >= 0, got {n}")
    if n == 0:
        return min(8, os.cpu_count() or 1)
    return int(n)


class OrderedParsePool:
    """Fixed worker pool mapping a function over an iterable with
    in-order emission and a bounded in-flight window.

    The protocol mirrors ``drive_prefetched``'s ONE-producer shape:
    daemon worker threads (joined in :meth:`close`, which ``map`` always
    reaches via its ``finally``), a single Condition guarding all shared
    state, and worker exceptions carried back to the caller's thread and
    re-raised at the failed chunk's in-order position — so fault
    injection (``chunk_faults``) and salvage semantics are
    indistinguishable from the serial scan's.
    """

    def __init__(self, fn: Callable, n_threads: int):
        self._fn = fn
        self._cond = threading.Condition()
        self._tasks: deque = deque()        # (idx, payload) FIFO
        self._results: dict = {}            # idx -> (ok, value-or-exc)
        self._stop = False
        self._next_submit = 0
        self._next_emit = 0
        self._window = 2 * max(int(n_threads), 1)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"parse-pool-{i}")
            for i in range(max(int(n_threads), 1))]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._tasks and not self._stop:
                    self._cond.wait()
                if not self._tasks:
                    return                  # stop requested, queue drained
                idx, payload = self._tasks.popleft()
            try:
                out = (True, self._fn(payload))
            except BaseException as e:      # carried to the caller thread
                out = (False, e)
            with self._cond:
                self._results[idx] = out
                self._cond.notify_all()

    def map(self, payloads: Iterable) -> Iterator:
        """Yield ``fn(payload)`` per payload, strictly in input order.
        A worker exception re-raises here at that payload's position
        (later in-flight results are discarded with the pool)."""
        it = iter(payloads)
        exhausted = False
        try:
            while True:
                while not exhausted:
                    with self._cond:
                        if self._next_submit - self._next_emit >= self._window:
                            break
                    try:
                        p = next(it)        # caller-side work: off-lock
                    except StopIteration:
                        exhausted = True
                        break
                    with self._cond:
                        self._tasks.append((self._next_submit, p))
                        self._next_submit += 1
                        self._cond.notify()
                with self._cond:
                    if exhausted and self._next_emit == self._next_submit:
                        return
                    while self._next_emit not in self._results:
                        self._cond.wait()
                    ok, value = self._results.pop(self._next_emit)
                    self._next_emit += 1
                if not ok:
                    raise value
                yield value
        finally:
            self.close()

    def close(self) -> None:
        """Stop the workers (they drain queued tasks first) and join."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()
