"""Deterministic fault injection: the port's copy of the training-path
half of ``avenir_tpu/core/faultinject.py``.

A fault plan parsed from the job config names which fault fires at which
occurrence index of which instrumented point, so a recovery test (retry,
checkpoint and resume, quarantine) is an ordinary deterministic test, not
a race.

Config surface:

- ``fault.inject.plan`` -- comma or semicolon separated entries::

      <point>[<tag>]@<index>[-<index2>|*][x<count>][:<arg>]

  e.g. ``read@0-1`` (the first two file-read attempts raise a transient
  I/O error, the third succeeds), ``corrupt@3`` (chunk 3's bytes are
  mangled), ``slow@5:50`` (a 50 ms stall at chunk 5), ``h2d@4`` (chunk
  4's host-to-device transfer raises: fail fast, leaving the checkpoint
  for ``--resume``), ``worker_death@6`` (the prefetch worker dies without
  relaying an error: the consumer's watchdog path).  ``x<count>``
  repeats a fault at one index; the optional ``[<tag>]`` restricts an
  entry to call sites that fire with that tag.
- ``fault.inject.seed`` -- seeds the corruption byte generator (default
  2026), so a corrupted chunk is byte-identical across runs.

Instrumented points (the ones the NB training path fires):

================  ======================================================
``read``          file-read attempts (``native._read_buffer``): raises
                  ``InjectedReadError``, an ``OSError``, so it is retried
``corrupt``       byte chunks by chunk index: the bytes are overwritten
                  (``mangle``), nothing is raised
``slow``          byte chunks by chunk index: sleeps ``arg`` ms
                  (default 20)
``h2d``           host-to-device chunk transfers: raises
                  ``InjectedFault`` (not retryable)
``worker_death``  byte chunks by chunk index, on the prefetch worker:
                  raises ``SimulatedWorkerDeath``, a BaseException the
                  worker's relay deliberately does not catch
================  ======================================================

The serving, stream and workflow points of the reference wait for their
slices.  ``get_injector()`` returns None until a plan is configured and
every call site checks that first, so an unplanned run does no work here.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Tuple

from . import sanitizer

DEFAULT_SEED = 2026

KEY_PLAN = "fault.inject.plan"
KEY_SEED = "fault.inject.seed"

#: the known instrumented points (a parse-time typo guard)
POINTS = ("read", "corrupt", "slow", "h2d", "worker_death")


class InjectedReadError(OSError):
    """An injected transient I/O failure: an OSError, so the default
    retry policy (core.resilience) retries it."""


class InjectedFault(RuntimeError):
    """An injected non-retryable failure (e.g. a host-to-device transfer
    error): the job fails fast, leaving any checkpoint for ``--resume``."""


class SimulatedWorkerDeath(BaseException):
    """A worker thread dying without running its error relay.  A
    BaseException, so ``except Exception`` handlers do not swallow it."""


class _Entry:
    __slots__ = ("point", "lo", "hi", "count", "arg", "tag")

    def __init__(self, point: str, lo: int, hi: Optional[int],
                 count: int, arg: Optional[str], tag: Optional[str] = None):
        self.point = point
        self.lo = lo
        self.hi = hi          # None = unbounded (the `*` index)
        self.count = count    # firings per matched index (x<count>)
        self.arg = arg
        self.tag = tag        # None = any call site

    def matches(self, index: int, tag: Optional[str] = None) -> bool:
        if self.tag is not None and tag != self.tag:
            return False
        return index >= self.lo and (self.hi is None or index <= self.hi)

    def __repr__(self):
        hi = "*" if self.hi is None else self.hi
        t = f"[{self.tag}]" if self.tag else ""
        return (f"_Entry({self.point}{t}@{self.lo}-{hi}"
                f"x{self.count}:{self.arg})")


def parse_plan(text: str) -> List[_Entry]:
    """Parse a ``fault.inject.plan`` value into entries (see the module
    docstring for the grammar)."""
    entries: List[_Entry] = []
    for raw in text.replace(";", ",").split(","):
        s = raw.strip()
        if not s:
            continue
        if "@" not in s:
            raise ValueError(f"bad fault plan entry (no '@'): {s!r}")
        point, _, spec = s.partition("@")
        point = point.strip()
        tag: Optional[str] = None
        if point.endswith("]") and "[" in point:
            point, _, tag = point[:-1].partition("[")
            point = point.strip()
            tag = tag.strip()
            if not tag:
                raise ValueError(f"empty tag qualifier in {s!r}")
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {', '.join(POINTS)}")
        arg: Optional[str] = None
        if ":" in spec:
            spec, _, arg = spec.partition(":")
        count = 1
        if "x" in spec:
            spec, _, cnt = spec.partition("x")
            count = int(cnt)
            if count < 1:
                raise ValueError(f"bad fault count in {s!r}")
        spec = spec.strip()
        if spec == "*":
            lo, hi = 0, None
        elif "-" in spec:
            a, _, b = spec.partition("-")
            lo, hi = int(a), int(b)
        else:
            lo = hi = int(spec)
        entries.append(_Entry(point, lo, hi, count, arg, tag))
    return entries


class FaultInjector:
    """Fires the planned faults, deterministically per (entry, index).

    Call sites pass an explicit index where the point has one (the chunk
    index); otherwise the injector keeps a per-point occurrence counter
    (file reads).  Each matched (entry, index) fires at most
    ``entry.count`` times, so ``read@0x2`` is a transient fault (two
    failures, then success) and ``read@0x99`` a persistent one."""

    def __init__(self, plan: List[_Entry], seed: int = DEFAULT_SEED):
        self.plan = plan
        self.seed = int(seed)
        self._lock = sanitizer.make_lock("core.faultinject")
        self._auto: Dict[str, int] = {}
        self._fired: Dict[Tuple[int, int, Optional[str]], int] = {}
        self.fired_log: List[Tuple[str, int]] = []

    def _next_index(self, point: str, tag: Optional[str] = None) -> int:
        key = point if tag is None else f"{point}[{tag}]"
        with self._lock:
            i = self._auto.get(key, 0)
            self._auto[key] = i + 1
            return i

    def _due(self, point: str, index: Optional[int],
             tag: Optional[str] = None):
        """The first still-armed entry matching (point, index, tag),
        consuming one firing; None when nothing fires."""
        if index is None:
            index = self._next_index(point, tag)
        with self._lock:
            for eid, e in enumerate(self.plan):
                if e.point != point or not e.matches(index, tag):
                    continue
                k = (eid, index, tag)
                if self._fired.get(k, 0) >= e.count:
                    continue
                self._fired[k] = self._fired.get(k, 0) + 1
                self.fired_log.append((point, index))
                return e
        return None

    def fire(self, point: str, index: Optional[int] = None,
             tag: Optional[str] = None) -> None:
        """Raise or sleep per the plan at an instrumented point (no-op
        when no armed entry matches)."""
        e = self._due(point, index, tag)
        if e is None:
            return
        where = f"{point}@{index if index is not None else 'auto'}"
        if point == "read":
            raise InjectedReadError(f"injected transient read error ({where})")
        if point == "slow":
            time.sleep(float(e.arg or 20) / 1000.0)
            return
        if point == "h2d":
            raise InjectedFault(f"injected H2D transfer failure ({where})")
        if point == "worker_death":
            raise SimulatedWorkerDeath(f"injected worker death ({where})")
        raise InjectedFault(f"injected fault ({where})")

    def mangle(self, point: str, index: int, data: bytes) -> bytes:
        """``data`` corrupted per the plan (identity when no armed entry
        matches).  ``arg`` "truncate" drops the chunk's second half; the
        default overwrites the letters and digits of a seeded 64-byte
        window with non-ASCII bytes, keeping delimiters and newlines, so
        every row it touches keeps its fields but stops parsing."""
        e = self._due(point, index)
        if e is None or not data:
            return data
        if e.arg == "truncate":
            return data[:max(len(data) // 2, 1)]
        rng = random.Random(self.seed * 1_000_003 + index)
        span = min(len(data), 64)
        start = rng.randrange(max(len(data) - span, 1))
        window = bytearray(data[start:start + span])
        for i, b in enumerate(window):
            if (0x30 <= b <= 0x39 or 0x41 <= b <= 0x5A
                    or 0x61 <= b <= 0x7A):
                window[i] = rng.randrange(0x80, 0xFF)
        return data[:start] + bytes(window) + data[start + span:]


_INJECTOR: Optional[FaultInjector] = None


def get_injector() -> Optional[FaultInjector]:
    """The process-global injector, or None when no plan is configured."""
    return _INJECTOR


def set_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _INJECTOR
    _INJECTOR = inj
    return inj


def configure_from_config(config) -> Optional[FaultInjector]:
    """Install the injector ``fault.inject.plan`` describes (clears any
    previous one when the key is absent)."""
    text = config.get(KEY_PLAN)
    if not text:
        return set_injector(None)
    return set_injector(FaultInjector(
        parse_plan(text), seed=config.get_int(KEY_SEED, DEFAULT_SEED)))
