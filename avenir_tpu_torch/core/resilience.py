"""Retry with backoff and malformed-row quarantine: the port's copy of
``avenir_tpu/core/resilience.py``.

- :func:`with_retries` runs a call that may fail transiently (a file
  read, the native library's compile) under bounded exponential backoff
  with seeded jitter.  Retried attempts count in the module's ``Retry``
  counters and record a ``retry.backoff`` span while tracing is on.
- :class:`RowQuarantine` routes rows that do not decode to a sidecar file
  under an error budget (``ingest.error.budget``: a row count, or a
  fraction of the rows seen); past the budget the job fails with an error
  that names the sidecar, so data loss stays bounded and auditable.

Config surface:

- ``retry.max.attempts``     -- total attempts per call (default 3)
- ``retry.backoff.base.ms``  -- the first backoff sleep (default 10;
  doubles per attempt)
- ``retry.backoff.max.ms``   -- the backoff ceiling (default 2000)
- ``retry.backoff.jitter``   -- uniform jitter fraction on each sleep
  (default 0.5), drawn from a ``retry.seed``-seeded generator
- ``ingest.error.budget``    -- the quarantine budget: an int >= 1 is a
  row count, a float in (0, 1) a fraction of the rows seen; absent turns
  quarantine off (a malformed row then fails the chunked path)
- ``ingest.quarantine.path`` -- the sidecar (default ``<out>.quarantine``)

The reference's ``NON_RETRYABLE`` registry feeds a lint of the JAX suite
and is not copied.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from . import sanitizer
from .metrics import Counters
from .obs import get_tracer

KEY_MAX_ATTEMPTS = "retry.max.attempts"
KEY_BACKOFF_BASE = "retry.backoff.base.ms"
KEY_BACKOFF_MAX = "retry.backoff.max.ms"
KEY_BACKOFF_JITTER = "retry.backoff.jitter"
KEY_RETRY_SEED = "retry.seed"
KEY_ERROR_BUDGET = "ingest.error.budget"
KEY_QUARANTINE_PATH = "ingest.quarantine.path"

RETRY_GROUP = "Retry"

#: exception classes retried by default: the transient I/O family (an
#: injected non-retryable fault is a RuntimeError and fails fast)
RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (OSError,)

#: OSError subclasses that are never transient for local files: a
#: mistyped path fails at once, not after the whole backoff ladder
NON_TRANSIENT_OS: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, IsADirectoryError, NotADirectoryError)


class RetryPolicy:
    """One retry budget: attempts, backoff ladder, retryable classes."""

    __slots__ = ("max_attempts", "base_ms", "max_ms", "jitter", "retryable",
                 "_rng", "_lock")

    def __init__(self, max_attempts: int = 3, base_ms: float = 10.0,
                 max_ms: float = 2000.0, jitter: float = 0.5,
                 retryable: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1: {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.jitter = float(jitter)
        self.retryable = tuple(retryable)
        self._rng = random.Random(seed)
        self._lock = sanitizer.make_lock("core.retry")

    @classmethod
    def from_config(cls, config) -> "RetryPolicy":
        return cls(
            max_attempts=config.get_int(KEY_MAX_ATTEMPTS, 3),
            base_ms=config.get_float(KEY_BACKOFF_BASE, 10.0),
            max_ms=config.get_float(KEY_BACKOFF_MAX, 2000.0),
            jitter=config.get_float(KEY_BACKOFF_JITTER, 0.5),
            seed=config.get_int(KEY_RETRY_SEED, 0))

    def backoff_s(self, attempt: int) -> float:
        """The sleep before retry ``attempt`` (1-based), in seconds:
        ``min(base * 2^(attempt-1), max) * (1 + jitter*u)`` with ``u``
        from the seeded generator."""
        base = min(self.base_ms * (2.0 ** (attempt - 1)), self.max_ms)
        with self._lock:
            u = self._rng.random()
        return base * (1.0 + self.jitter * u) / 1000.0

    def is_retryable(self, exc: BaseException) -> bool:
        return (isinstance(exc, self.retryable)
                and not isinstance(exc, NON_TRANSIENT_OS))


_POLICY = RetryPolicy()
_COUNTERS = Counters()


def set_policy(policy: RetryPolicy) -> RetryPolicy:
    global _POLICY
    _POLICY = policy
    return policy


def configure_from_config(config) -> RetryPolicy:
    """Apply the ``retry.*`` keys to the process-global policy."""
    return set_policy(RetryPolicy.from_config(config))


def retry_counters() -> Counters:
    """The module's ``Retry`` group: ``attempts`` counts every retried
    call attempt, ``exhausted`` the calls that used the whole budget."""
    return _COUNTERS


def with_retries(fn: Callable, *args, op: str = "io",
                 policy: Optional[RetryPolicy] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the retry policy: a retryable
    exception sleeps the backoff ladder and tries again, up to
    ``max_attempts`` tries in all; the last failure, or any exception
    that is not retryable, propagates unchanged."""
    pol = policy or _POLICY
    tracer = get_tracer()
    attempt = 1
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — classified, re-raised
            if not pol.is_retryable(exc) or attempt >= pol.max_attempts:
                if pol.is_retryable(exc):
                    _COUNTERS.incr(RETRY_GROUP, "exhausted")
                    _COUNTERS.incr(RETRY_GROUP, f"exhausted.{op}")
                raise
            _COUNTERS.incr(RETRY_GROUP, "attempts")
            _COUNTERS.incr(RETRY_GROUP, f"attempts.{op}")
            delay = pol.backoff_s(attempt)
            with tracer.span("retry.backoff", op=op, attempt=attempt,
                             error=f"{type(exc).__name__}: {exc}"):
                time.sleep(delay)
            attempt += 1


class ErrorBudgetExceeded(RuntimeError):
    """More rows were quarantined than ``ingest.error.budget`` allows;
    the message names the quarantine file."""


class RowQuarantine:
    """Sidecar file and budget for malformed input rows.

    ``admit(n)`` counts rows seen (good and bad); ``record(lines,
    reason)`` appends bad rows to the sidecar and enforces the budget: a
    row-count budget fails as soon as the count passes it, a fractional
    one is checked against the rows seen so far after each recorded
    batch and once more at :meth:`finish`.  The sidecar is an
    append-only log (one ``# reason`` line per batch); after a kill and
    ``--resume``, re-processed chunks may append duplicates: the budget's
    accounting lives in the checkpoint state, not in the file.
    """

    __slots__ = ("path", "budget", "fraction", "seen", "quarantined",
                 "_lock", "_opened")

    #: a fractional budget needs a denominator first: mid-stream checks
    #: wait until this many rows were seen (bad rows at the head of the
    #: file are recorded before their chunk's good rows are counted);
    #: the end-of-stream check (``finish``) is unconditional
    FRACTION_MIN_SEEN = 1024

    def __init__(self, path: str, budget_spec: str):
        self.path = path
        spec = str(budget_spec).strip()
        val = float(spec)
        if val <= 0:
            raise ValueError(
                f"{KEY_ERROR_BUDGET} must be positive: {budget_spec!r}")
        self.fraction = ("." in spec or "e" in spec.lower()) and val < 1.0
        self.budget = val
        self.seen = 0
        self.quarantined = 0
        self._lock = sanitizer.make_lock("core.rowquarantine")
        self._opened = False

    @classmethod
    def from_config(cls, config,
                    default_path: str) -> Optional["RowQuarantine"]:
        spec = config.get(KEY_ERROR_BUDGET)
        if spec is None:
            return None
        return cls(config.get(KEY_QUARANTINE_PATH, default_path), spec)

    def admit(self, n_rows: int) -> None:
        with self._lock:
            self.seen += int(n_rows)

    def record(self, lines, reason: str) -> None:
        """Quarantine a batch of raw row lines; raises
        :class:`ErrorBudgetExceeded` past the budget."""
        lines = list(lines)
        if not lines:
            return
        with self._lock:
            self.quarantined += len(lines)
            self.seen += len(lines)
        self._write(lines, reason)
        self.check()

    def _write(self, lines, reason: str) -> None:
        mode = "a" if self._opened else "w"
        self._opened = True
        with open(self.path, mode) as fh:
            fh.write(f"# {reason} ({len(lines)} rows)\n")
            for line in lines:
                fh.write(line if isinstance(line, str)
                         else line.decode("utf-8", errors="replace"))
                fh.write("\n")

    def _over_budget(self, final: bool) -> bool:
        if self.fraction:
            if not final and self.seen < self.FRACTION_MIN_SEEN:
                return False
            return (self.seen > 0
                    and self.quarantined > self.budget * self.seen)
        return self.quarantined > self.budget

    def check(self, final: bool = False) -> None:
        if self._over_budget(final):
            kind = (f"{self.budget:g} of rows seen" if self.fraction
                    else f"{int(self.budget)} rows")
            raise ErrorBudgetExceeded(
                f"ingest error budget exceeded: {self.quarantined} malformed "
                f"rows quarantined (budget {kind}, {self.seen} rows seen) — "
                f"inspect {self.path}")

    def finish(self, counters: Optional[Counters] = None) -> None:
        """The end-of-stream budget check, and the ``Ingest /
        Quarantined rows`` counter."""
        self.check(final=True)
        if counters is not None and self.quarantined:
            counters.set("Ingest", "Quarantined rows", self.quarantined)

    def state(self) -> dict:
        with self._lock:
            return {"seen": self.seen, "quarantined": self.quarantined}

    def restore(self, state: dict) -> None:
        with self._lock:
            self.seen = int(state["seen"])
            self.quarantined = int(state["quarantined"])
        self._opened = True      # append after a resume, never truncate


def row_guard(enc) -> Callable:
    """A validity predicate over split field lists for ``enc``'s schema:
    enough fields, numeric feature columns parse as floats, bucket
    columns as integers."""
    int_ords = [f.ordinal for f in enc.feature_fields
                if f.is_bucket_width_defined()]
    float_ords = [f.ordinal for f in enc.feature_fields
                  if not f.is_categorical()
                  and not f.is_bucket_width_defined()]
    needed = [f.ordinal for f in enc.feature_fields]
    if enc.class_field is not None:
        needed.append(enc.class_field.ordinal)
    if enc.id_field is not None:
        needed.append(enc.id_field.ordinal)
    min_fields = max(needed) + 1

    def ok(fields) -> bool:
        if len(fields) < min_fields:
            return False
        try:
            for o in int_ords:
                int(fields[o])
            for o in float_ords:
                float(fields[o])
        except ValueError:
            return False
        return True

    return ok


def salvage_chunk(enc, quarantine: RowQuarantine, delim: str) -> Callable:
    """The per-chunk salvage ``(chunk_bytes) -> (x, values, y, n)`` for a
    chunk the native encoder rejects: decode it row by row, quarantine
    the rows that fail :func:`row_guard`, and encode the rest with the
    same shared vocabularies, so a chunk with k bad rows contributes
    exactly what the file without those rows would."""
    import numpy as np
    from .binning import ChunkedEncodeUnsupported
    from .io import split_line

    guard = row_guard(enc)
    F = len(enc.feature_fields)

    def salvage(chunk: bytes):
        lines = chunk.decode("utf-8", errors="replace").split("\n")
        good, bad = [], []
        for line in lines:
            if not line:
                continue
            fields = split_line(line, delim)
            (good if guard(fields) else bad).append((line, fields))
        if bad:
            quarantine.record([l for l, _ in bad],
                              "rows rejected by schema guard")
        if not good:
            return (np.zeros((0, F), np.int32), np.zeros((0, F)),
                    np.zeros(0, np.int32), 0)
        dsc = enc.encode([fields for _, fields in good])
        if (dsc.bin_offset != 0).any():
            # a negative bin is a cap condition, not bad data: keep the
            # streamed path's fallback
            raise ChunkedEncodeUnsupported("negative bin")
        return dsc.x, dsc.values, dsc.y, dsc.n_rows

    return salvage
