"""Deterministic fault injection: seeded, config-driven fault plans.

The reference substrate got fault tolerance for free — Hadoop re-executes
failed map tasks, Storm replays tuples — so the original codebase has no
recovery paths to test.  This package's recovery paths (retry with
backoff, checkpoint/resume, quarantine, serving circuit breakers; see
``core.resilience`` / ``core.checkpoint`` / ``serve.breaker``) only stay
honest if every fault class they claim to handle can be produced ON
DEMAND and REPRODUCIBLY.  This module is that switchboard: a fault plan
parsed from the job config names which fault fires at which occurrence
index of which instrumented point, so a recovery test is an ordinary
deterministic test, not a race.

Config surface (the .properties files every job loads):

- ``fault.inject.plan`` — semicolon/comma-separated entries::

      <point>[<tag>]@<index>[-<index2>|*][x<count>][:<arg>]

  The optional ``[<tag>]`` qualifier restricts an entry to call sites
  firing with that tag (serving batchers tag scorer points with their
  model VARIANT, so ``scorer_slow[f32]@*:40`` slows only the f32
  variant — the router-demotion test); untagged entries fire at every
  site.  e.g. ``read@0-1`` (the first two file-read attempts raise a transient
  I/O error, the third succeeds — the retry path; auto-indexed points
  count every CALL, so consecutive failures are index ranges, while
  ``x<count>`` repeats a fault at one explicit chunk index across
  retries of that same chunk), ``corrupt@3`` (chunk 3's bytes
  are mangled — the quarantine path), ``slow@5:50`` (a 50 ms stall at
  chunk 5), ``h2d@4`` (chunk 4's device transfer raises — fail fast with
  a resumable checkpoint), ``worker_death@6`` (the prefetch worker dies
  WITHOUT relaying an error — the consumer watchdog path),
  ``scorer@0-7`` (the first 8 scorer batches fail — opens the serving
  circuit breaker), ``batcher_death@0`` (a batcher worker thread dies —
  the serving watchdog restart path).
- ``fault.inject.seed`` — seeds the corruption byte generator (default
  2026) so a corrupted chunk is byte-identical across runs.

Instrumented points (grep ``fire(`` / ``mangle(`` call sites):

====================  =====================================================
``read``              file-read attempts (``native._read_buffer``, the
                      line-chunk reader) — raises ``InjectedReadError``
                      (an ``OSError``: retryable)
``corrupt``           byte chunks by chunk index — bytes are overwritten
                      (``mangle``), not raised
``slow``              byte chunks by chunk index — sleeps ``arg`` ms
                      (default 20)
``h2d``               host->device chunk transfers — raises
                      ``InjectedFault`` (non-retryable)
``worker_death``      byte chunks by chunk index, on the prefetch worker
                      — raises ``SimulatedWorkerDeath`` (a BaseException
                      the relay deliberately does NOT catch)
``scorer``            serving scorer batches — raises
                      ``InjectedScorerFault``
``scorer_slow``       serving scorer batches — sleeps ``arg`` ms
                      (default 20): the deterministic slow scorer that
                      drives a windowed p99 past ``serve.slo.p99.ms``
                      (the SLO-violation test in tests/test_slo.py)
``batcher_death``     serving batcher worker loop iterations — raises
                      ``SimulatedWorkerDeath``
``scorer_poison``     serving scorer batches whose lines contain the
                      entry's ``arg`` marker (default "POISON") — raises
                      ``InjectedScorerFault`` for the WHOLE batch, like a
                      real poison row does (the bisect-isolation path in
                      serve/batcher.py; content-based, so every rescored
                      sub-batch containing the row fails too)
``torn_write``        ``OutputWriter.close`` publishes — simulates the
                      legacy in-place writer crashing mid-write: half the
                      staged bytes land at the final path with NO
                      manifest/_SUCCESS update, then ``InjectedFault``
                      (the reader-validation / safe-reload path)
``ckpt_corrupt``      checkpoint sidecar saves by save index — the
                      just-written sidecar is truncated in place after a
                      successful save (crash mid-checkpoint-write /disk
                      corruption; the generation-fallback path)
``feedback_dup``      feedback-consumer read batches by batch index —
                      the delivered entries are delivered AGAIN in the
                      same batch (at-least-once redelivery; the offset
                      watermark must dedupe — ``armed``, enacted by the
                      consumer)
``feedback_reorder``  feedback-consumer read batches by batch index —
                      the delivered entries arrive in reversed order
                      (the consumer's id sort must restore application
                      order — ``armed``, enacted by the consumer)
``feedback_drop``     feedback-consumer read batches by batch index —
                      raises ``InjectedFault`` AFTER the transport
                      delivered the batch but BEFORE any of it was
                      applied (consumer crash: the entries stay pending
                      unacked and must be redelivered on resume with
                      zero drops or double-applies)
``promote_slow``      model-cache promote jobs (serve/modelcache.py),
                      fired with the MODEL NAME as the call-site tag —
                      sleeps ``arg`` ms (default 20): deterministic slow
                      cold starts for the retry_after / deadline tests
``promote_fail``      model-cache promote jobs (tagged by model name) —
                      raises ``InjectedFault`` before any variant group
                      builds: the promote fails structurally and the
                      previously-resident set keeps serving untouched
                      (the chaos test in tests/test_modelcache.py)
====================  =====================================================

Disabled-mode cost: ``get_injector()`` returns None until a plan is
configured, and every call site guards on that — zero work on the hot
path.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import sanitizer

DEFAULT_SEED = 2026

KEY_PLAN = "fault.inject.plan"
KEY_SEED = "fault.inject.seed"

#: the known instrumented points (parse-time typo guard)
POINTS = ("read", "corrupt", "slow", "h2d", "worker_death", "scorer",
          "scorer_slow", "batcher_death", "scorer_poison", "torn_write",
          "ckpt_corrupt", "feedback_dup", "feedback_reorder",
          "feedback_drop", "promote_slow", "promote_fail")


class InjectedReadError(OSError):
    """Injected transient I/O failure — an OSError, so the default
    retry policy (core.resilience) retries it."""


class InjectedFault(RuntimeError):
    """Injected non-retryable failure (e.g. an H2D transfer error): the
    job must fail fast, leaving any checkpoint behind for ``--resume``."""


class InjectedScorerFault(RuntimeError):
    """Injected serving scorer failure (feeds the circuit breaker)."""


class SimulatedWorkerDeath(BaseException):
    """Simulates a worker thread dying WITHOUT running its error relay
    (the hard-death case: the relay itself is what failed).  Derives
    from BaseException so ``except Exception`` handlers — including the
    batcher's per-batch guard — do not swallow it."""


class _Entry:
    __slots__ = ("point", "lo", "hi", "count", "arg", "tag")

    def __init__(self, point: str, lo: int, hi: Optional[int],
                 count: int, arg: Optional[str], tag: Optional[str] = None):
        self.point = point
        self.lo = lo
        self.hi = hi          # None = unbounded (the `*` index)
        self.count = count    # firings per matched index (x<count>)
        self.arg = arg
        self.tag = tag        # None = any call site; else only sites
        #                       firing with this tag (e.g. a serving
        #                       scorer variant: scorer_slow[f32]@*)

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
    """Parse a ``fault.inject.plan`` value into entries (see module
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
            # optional call-site tag qualifier: point[tag]@spec — the
            # entry fires only at sites passing fire(..., tag=<tag>)
            # (e.g. one serving scorer VARIANT: scorer_slow[f32]@*:40)
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
    """Fires the planned faults; deterministic per (entry, index).

    Call sites pass an explicit index when the point has a natural one
    (chunk index); otherwise the injector keeps a per-point occurrence
    counter (file reads, scorer batches).  Each matched (entry, index)
    fires at most ``entry.count`` times — so a plan like ``read@0x2``
    models a TRANSIENT fault (two failures, then success: the retry
    path) while ``read@0x99`` models a persistent one (the retry budget
    exhausts and the job fails)."""

    def __init__(self, plan: List[_Entry], seed: int = DEFAULT_SEED):
        self.plan = plan
        self.seed = int(seed)
        self._lock = sanitizer.make_lock("core.faultinject")
        self._auto: Dict[str, int] = {}
        self._fired: Dict[Tuple[int, int], int] = {}
        self.fired_log: List[Tuple[str, int]] = []

    # -- index bookkeeping -------------------------------------------------
    def _next_index(self, point: str, tag: Optional[str] = None) -> int:
        # per-(point, tag) occurrence counters so tagged call sites
        # (e.g. two scorer variants) keep deterministic indices no
        # matter how their firings interleave
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
                # the fired budget is keyed per call-site tag too: an
                # UNTAGGED entry like scorer@0 fires at each tagged
                # site's own index 0 (deterministic per site) instead
                # of being consumed by whichever site races there first
                k = (eid, index, tag)
                if self._fired.get(k, 0) >= e.count:
                    continue
                self._fired[k] = self._fired.get(k, 0) + 1
                self.fired_log.append((point, index))
                return e
        return None

    # -- the injection points ----------------------------------------------
    def armed(self, point: str, index: Optional[int] = None,
              tag: Optional[str] = None):
        """The armed entry matching (point, index, tag), CONSUMING one
        firing, or None — for points whose fault is enacted by the call
        site itself rather than raised here (``torn_write`` tears the
        staged file, ``ckpt_corrupt`` truncates the just-written
        sidecar)."""
        return self._due(point, index, tag)

    def fire_poison(self, lines, tag: Optional[str] = None) -> None:
        """The ``scorer_poison`` point: raise InjectedScorerFault when
        any of the batch's ``lines`` contains an armed entry's marker
        (``arg``, default "POISON").  Content-based, so the bisect
        isolation in serve/batcher.py deterministically re-fails every
        rescored sub-batch still containing the poison row while its
        cohabitants' sub-batches succeed."""
        matched = [
            (eid, e) for eid, e in enumerate(self.plan)
            if e.point == "scorer_poison"
            and (e.tag is None or e.tag == tag)
            and any((e.arg or "POISON") in l for l in lines)]
        if not matched:
            return
        # one occurrence index per marker-matching batch; the firing
        # budget consumed belongs to the entry whose marker matched (an
        # exhausted entry falls through to the next matching one, so a
        # multi-marker plan's budgets stay independent)
        index = self._next_index("scorer_poison", tag)
        with self._lock:
            for eid, e in matched:
                if not e.matches(index, tag):
                    continue
                k = (eid, index, tag)
                if self._fired.get(k, 0) >= e.count:
                    continue
                self._fired[k] = self._fired.get(k, 0) + 1
                self.fired_log.append(("scorer_poison", index))
                raise InjectedScorerFault(
                    f"injected poison-batch failure "
                    f"(marker {(e.arg or 'POISON')!r} in batch)")

    def fire(self, point: str, index: Optional[int] = None,
             tag: Optional[str] = None) -> None:
        """Raise/sleep per the plan at an instrumented point (no-op when
        no armed entry matches).  ``tag`` identifies the call site for
        tag-qualified plan entries (``point[tag]@...``); untagged
        entries fire regardless of the site's tag."""
        e = self._due(point, index, tag)
        if e is None:
            return
        where = f"{point}@{index if index is not None else 'auto'}"
        if point == "read":
            raise InjectedReadError(f"injected transient read error ({where})")
        if point in ("slow", "scorer_slow", "promote_slow"):
            time.sleep(float(e.arg or 20) / 1000.0)
            return
        if point == "h2d":
            raise InjectedFault(f"injected H2D transfer failure ({where})")
        if point in ("worker_death", "batcher_death"):
            raise SimulatedWorkerDeath(f"injected worker death ({where})")
        if point == "scorer":
            raise InjectedScorerFault(f"injected scorer failure ({where})")
        raise InjectedFault(f"injected fault ({where})")     # corrupt via
        #                                                      mangle() only

    def mangle(self, point: str, index: int, data: bytes) -> bytes:
        """Return ``data`` corrupted per the plan (identity when no armed
        entry matches).  ``arg`` "truncate" drops the tail half of the
        chunk mid-line; the default garbles a seeded window by
        overwriting its alphanumeric bytes with non-ASCII garbage while
        PRESERVING delimiters and newlines — every overlapped row keeps
        its field structure but its numeric fields stop parsing, so the
        corruption is reliably detected row-by-row (the quarantine
        path) instead of occasionally fusing two rows into one
        structurally-valid record that would slip through unlogged."""
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
    """The process-global injector, or None when no plan is configured
    (the hot-path guard every call site uses)."""
    return _INJECTOR


def set_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _INJECTOR
    _INJECTOR = inj
    return inj


def configure_from_config(config) -> Optional[FaultInjector]:
    """Install the injector described by ``fault.inject.plan`` (clears
    any previous injector when the key is absent)."""
    text = config.get(KEY_PLAN)
    if not text:
        return set_injector(None)
    return set_injector(FaultInjector(
        parse_plan(text), seed=config.get_int(KEY_SEED, DEFAULT_SEED)))
