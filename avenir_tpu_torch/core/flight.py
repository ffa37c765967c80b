"""Failure flight recorder: the always-on black box behind every anomaly.

The obs/telemetry layers can say *that* p99 regressed or a
breaker tripped; this module records *what the system looked like in the
seconds before* — the aviation flight-recorder shape applied to serving
and batch workflows.  An always-on bounded ring collects:

- **wire errors** — every error/shed/poison response the serve layer
  produces (``serve/server.py``'s response chokepoint), stamped with the
  request's ``trace_id`` so a dump links back to the causal trace;
- **periodic metrics snapshots** — the mergeable ``core.telemetry``
  snapshot, captured lazily on the record stream and per telemetry
  exporter tick (``flight.snapshot.interval.sec`` apart);
- **anomaly marks** — every trigger below, whether or not it dumped.

Anomaly triggers — breaker trip, SLO soft-degrade, poison quarantine,
:class:`~avenir_tpu_torch.core.io.TornArtifactError`, systemic scorer failure,
fatal job exceptions (``cli.py``) — call :func:`trigger`, which appends
the anomaly mark and, when ``flight.dump.dir`` is configured, atomically
dumps the ring as a self-contained JSONL file (via the atomic
writer) named by trigger + trace_id: a header line, a metrics snapshot
at dump time, the ring records, then a tail of the tracer's recent
spans.  Dumps are rate-limited by ``flight.dump.min.interval.sec``
(forced triggers — process exit, fatal exceptions — bypass the limit).
``tests/test_obs_coverage.py`` lints that every anomaly trigger site in
the package calls this hook (or is excluded with a reason).

Config surface (the .properties files every job loads; README
"Observability"):

- ``flight.dump.dir``              — dump destination directory; unset
  (the default) keeps the ring recording but writes no files — safe for
  tests and libraries, one key to flip on the black box
- ``flight.dump.min.interval.sec`` — min seconds between dumps
  (default 30; forced triggers bypass)
- ``flight.ring.records``          — ring capacity in records
  (default 2048, oldest drop first)
- ``flight.snapshot.interval.sec`` — min seconds between periodic
  metrics snapshots in the ring (default 5; <= 0 disables them)
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Optional

from . import obs, sanitizer

KEY_DUMP_DIR = "flight.dump.dir"
KEY_MIN_INTERVAL = "flight.dump.min.interval.sec"
KEY_RING_RECORDS = "flight.ring.records"
KEY_SNAPSHOT_INTERVAL = "flight.snapshot.interval.sec"

DEFAULT_MIN_INTERVAL_SEC = 30.0
DEFAULT_RING_RECORDS = 2048
DEFAULT_SNAPSHOT_INTERVAL_SEC = 5.0

#: how many of the tracer's most recent records ride along in a dump
SPAN_TAIL_RECORDS = 512

FLIGHT_GROUP = "Flight"

_NAME_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")


class FlightRecorder:
    """Bounded in-memory ring + atomic anomaly dumps (thread-safe)."""

    def __init__(self, ring_records: int = DEFAULT_RING_RECORDS,
                 dump_dir: Optional[str] = None,
                 min_interval_sec: float = DEFAULT_MIN_INTERVAL_SEC,
                 snapshot_interval_sec: float = DEFAULT_SNAPSHOT_INTERVAL_SEC):
        self._ring: deque = deque(maxlen=max(int(ring_records), 1))
        self._lock = sanitizer.make_lock("core.flight")
        self.dump_dir = dump_dir
        self.min_interval = float(min_interval_sec)
        self.snapshot_interval = float(snapshot_interval_sec)
        self._last_dump = 0.0       # monotonic; 0.0 = never dumped
        self._last_snap = 0.0
        self.triggers = 0
        self.dumps = 0
        self.suppressed = 0

    # -- the record stream -------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one ring record (cheap; called off the response path
        only for error/shed/poison responses) and lazily capture a
        periodic metrics snapshot when one is due."""
        rec = {"t": time.time(), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)
        self.maybe_snapshot()

    def maybe_snapshot(self, force: bool = False) -> bool:
        """Capture one mergeable metrics snapshot into the ring when
        ``flight.snapshot.interval.sec`` has elapsed (driven by the
        record stream and by the serve telemetry exporter's tick)."""
        now = time.monotonic()
        with self._lock:
            if not force:
                if self.snapshot_interval <= 0:
                    return False
                if (self._last_snap
                        and now - self._last_snap < self.snapshot_interval):
                    return False
            self._last_snap = now
        try:
            from . import telemetry
            snap = telemetry.build_snapshot()
        except Exception:                               # noqa: BLE001
            return False
        with self._lock:
            self._ring.append({"t": time.time(), "kind": "metrics.snapshot",
                               "snapshot": snap})
        return True

    # -- anomaly triggers --------------------------------------------------
    def trigger(self, reason: str, trace_id: Optional[str] = None,
                force: bool = False, **detail) -> Optional[str]:
        """One anomaly: mark the ring, and dump it when a dump dir is
        configured and the rate limit allows (``force`` bypasses — exit
        flushes and fatal exceptions must leave the black box behind).
        Returns the dump path, or None when no file was written."""
        mark = {"t": time.time(), "kind": "anomaly", "reason": reason,
                "trace_id": trace_id}
        mark.update(detail)
        now = time.monotonic()
        with self._lock:
            self.triggers += 1
            self._ring.append(mark)
            if self.dump_dir is None:
                return None
            if (not force and self._last_dump
                    and now - self._last_dump < self.min_interval):
                self.suppressed += 1
                return None
            # reserve the rate-limit window (concurrent triggers must
            # not double-dump) but COMMIT it — and count the dump —
            # only on a successful write: an unwritable dump dir must
            # not suppress the next anomaly's retry or make stats claim
            # a black box that never hit disk
            prev_last = self._last_dump
            self._last_dump = now
            ring = list(self._ring)
        path = self._dump(reason, trace_id, ring)
        with self._lock:
            if path is not None:
                self.dumps += 1
            elif self._last_dump == now:
                self._last_dump = prev_last
        return path

    def _dump(self, reason: str, trace_id: Optional[str],
              ring: list) -> Optional[str]:
        # lazy imports: core.io's TornArtifactError hooks back into this
        # module, and telemetry pulls in obs config plumbing
        from .io import atomic_write_text
        from . import telemetry

        tag = trace_id if trace_id else str(int(time.time() * 1000))
        name = (f"flight-{_NAME_SAFE_RE.sub('_', reason)}-"
                f"{_NAME_SAFE_RE.sub('_', str(tag))}.jsonl")
        path = os.path.join(self.dump_dir, name)
        lines = [json.dumps({"kind": "flight.header", "reason": reason,
                             "trace_id": trace_id, "ts": time.time(),
                             "pid": os.getpid(),
                             "ring_records": len(ring)})]
        try:
            snap = telemetry.build_snapshot()
            lines.append(json.dumps({"kind": "metrics.snapshot",
                                     "at": "dump", "snapshot": snap}))
        except Exception:                               # noqa: BLE001
            pass
        for rec in ring:
            lines.append(json.dumps(rec, default=str))
        tr = obs.get_tracer()
        for r in tr.records()[-SPAN_TAIL_RECORDS:]:
            lines.append(json.dumps({"kind": "span.tail",
                                     **tr.record_dict(r)}))
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            atomic_write_text(path, "\n".join(lines) + "\n")
        except OSError:
            # an unwritable dump dir must never escalate the anomaly
            # it was meant to document
            return None
        try:
            telemetry.get_metrics().counters.incr(FLIGHT_GROUP, "Dumps")
        except Exception:                               # noqa: BLE001
            pass
        return path

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"ring_records": len(self._ring),
                    "ring_capacity": self._ring.maxlen,
                    "dump_dir": self.dump_dir,
                    "triggers": self.triggers, "dumps": self.dumps,
                    "suppressed": self.suppressed}

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.triggers = self.dumps = self.suppressed = 0
            self._last_dump = self._last_snap = 0.0


# ---------------------------------------------------------------------------
# the process-global recorder + config plumbing
# ---------------------------------------------------------------------------

_GLOBAL_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-global flight recorder (ring always on; dumping off
    until ``flight.dump.dir`` is configured)."""
    return _GLOBAL_RECORDER


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
    global _GLOBAL_RECORDER
    _GLOBAL_RECORDER = recorder
    return recorder


def read_dump_header(path: str) -> Optional[dict]:
    """The ``flight.header`` first line of a dump file as a dict
    (reason, trace_id, ts, pid, ring_records), or None when the file is
    missing, truncated, or not a flight dump.  Incident correlators
    (``fleetobs.incidents``) key on the header's ``trace_id``, NOT the
    filename tag — the tag doubles as a millisecond timestamp when the
    trigger carried no trace id, so parsing it back is ambiguous."""
    try:
        with open(path, "r") as fh:
            line = fh.readline()
    except OSError:
        return None
    try:
        doc = json.loads(line)
    except ValueError:
        return None
    if not isinstance(doc, dict) or doc.get("kind") != "flight.header":
        return None
    return doc


def sanitize_lock() -> None:
    """Re-wrap the global recorder's lock through the sanitizer.  The
    recorder is a module-import-time singleton, so its lock predates
    any ``sanitize.locks=true`` enablement; called at configure time
    (before worker threads exist) it brings the anomaly paths — which
    run while other tracked locks are held — into the order graph."""
    r = _GLOBAL_RECORDER
    if sanitizer.enabled() and not isinstance(r._lock,
                                              sanitizer.TrackedLock):
        r._lock = sanitizer.make_lock("core.flight")


def configure_from_config(config) -> FlightRecorder:
    """Apply the ``flight.*`` properties surface to the global recorder
    (called by every CLI entry point next to the obs configure)."""
    r = _GLOBAL_RECORDER
    sanitize_lock()
    r.dump_dir = config.get(KEY_DUMP_DIR) or None
    r.min_interval = config.get_float(KEY_MIN_INTERVAL,
                                      DEFAULT_MIN_INTERVAL_SEC)
    r.snapshot_interval = config.get_float(KEY_SNAPSHOT_INTERVAL,
                                           DEFAULT_SNAPSHOT_INTERVAL_SEC)
    cap = config.get_int(KEY_RING_RECORDS, DEFAULT_RING_RECORDS)
    with r._lock:
        if r._ring.maxlen != max(cap, 1):
            r._ring = deque(r._ring, maxlen=max(cap, 1))
    return r


def record(kind: str, **fields) -> None:
    _GLOBAL_RECORDER.record(kind, **fields)


def trigger(reason: str, trace_id: Optional[str] = None,
            force: bool = False, **detail) -> Optional[str]:
    """Module-level anomaly hook — what every trigger site calls."""
    return _GLOBAL_RECORDER.trigger(reason, trace_id=trace_id, force=force,
                                    **detail)


def fatal(exc: BaseException) -> Optional[str]:
    """A fatal job/serve exception: ring-record it and force a dump so a
    crashed process still leaves its black box behind (CLI entry points
    call this from their except paths)."""
    r = _GLOBAL_RECORDER
    return r.trigger("fatal", force=True, error=f"{type(exc).__name__}: "
                                                f"{exc}")


def flush_on_exit(reason: str = "exit") -> Optional[str]:
    """Final black-box flush for clean shutdowns (``serve_main``'s
    finally/SIGTERM path): force one dump of whatever the ring holds.
    No-op when no dump dir is configured."""
    r = _GLOBAL_RECORDER
    if r.dump_dir is None:
        return None
    return r.trigger(reason, force=True)
