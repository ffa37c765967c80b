"""The spool publisher: one process's telemetry, atomically on disk.

With ``fleetobs.spool.dir`` configured, a long-running entry point
publishes into ``<spool>/<identity label>/``:

- ``identity.json``  — the process identity record, written once
- ``snapshot.json``  — the latest full exporter snapshot (identity
  section included), wrapped with a monotone ``seq`` and the publish
  wall time; replaced atomically (``atomic_write_text``: mkstemp +
  fsync + rename), so the aggregator NEVER reads a torn snapshot
- ``trace.jsonl``    — incremental tracer records (rotations
  ``trace.jsonl.1`` …), flushed on each publish tick — the stitcher's
  input
- ``flight/``        — the process's flight dumps (``flight.dump.dir``
  is routed here unless explicitly configured elsewhere)

The publisher rides the existing :class:`TelemetryExporter` as a sink:
no second thread, no second snapshot — the JSONL line, the ``metrics``
scrape, and the spooled snapshot are the SAME dict per tick.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..core import flight, obs, sanitizer, telemetry
from ..core.io import atomic_write_text
from .identity import ProcessIdentity, new_identity

KEY_SPOOL_DIR = "fleetobs.spool.dir"
KEY_ROLE = "fleetobs.role"

SNAPSHOT_FILE = "snapshot.json"
IDENTITY_FILE = "identity.json"
TRACE_FILE = "trace.jsonl"
FLIGHT_SUBDIR = "flight"


class SpoolPublisher:
    """Publishes one process's telemetry into its spool feed.  Attach
    to a running exporter with :meth:`attach`; every exporter tick then
    atomically replaces ``snapshot.json`` and flushes new tracer
    records to the feed's ``trace.jsonl``."""

    def __init__(self, spool_dir: str, identity: ProcessIdentity,
                 tracer=None):
        self.identity = identity
        self.spool_dir = spool_dir
        self.dir = os.path.join(spool_dir, identity.label)
        self.seq = 0
        self._lock = sanitizer.make_lock("fleetobs.publisher")
        os.makedirs(self.dir, exist_ok=True)
        atomic_write_text(os.path.join(self.dir, IDENTITY_FILE),
                          json.dumps(identity.to_dict(), indent=2) + "\n")
        # interval 0 = never self-started: the flusher is driven
        # manually from publish(), so the publisher adds no thread
        self._flusher = telemetry.TraceFlusher(
            tracer if tracer is not None else obs.get_tracer(),
            os.path.join(self.dir, TRACE_FILE), interval_sec=0.0)

    @property
    def flight_dir(self) -> str:
        return os.path.join(self.dir, FLIGHT_SUBDIR)

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.dir, SNAPSHOT_FILE)

    def publish(self, snapshot: dict) -> str:
        """One atomic publish (the exporter-sink entry point)."""
        with self._lock:
            self.seq += 1
            doc = {"seq": self.seq, "published_unix": time.time(),
                   "label": self.identity.label, "snapshot": snapshot}
            atomic_write_text(self.snapshot_path, json.dumps(doc) + "\n")
        try:
            self._flusher.flush()
        except Exception:                               # noqa: BLE001
            pass            # trace flush must never break the publish
        return self.snapshot_path

    def attach(self, exporter: Optional[telemetry.TelemetryExporter],
               config=None) -> telemetry.TelemetryExporter:
        """Wire this publisher into ``exporter`` (identity stamp + sink).
        When the entry point had no exporter (a batch dag/multi run with
        no ``--metrics-out``), a spool-only exporter is created and
        STARTED — the caller owns stopping whatever comes back."""
        if exporter is None:
            interval = (config.get_float(telemetry.KEY_INTERVAL,
                                         telemetry.DEFAULT_INTERVAL_SEC)
                        if config is not None
                        else telemetry.DEFAULT_INTERVAL_SEC)
            exporter = telemetry.TelemetryExporter(interval).start()
        exporter.identity = self.identity.to_dict()
        exporter.sinks.append(self.publish)
        return exporter


def publisher_for_job(config, role: str) -> Optional[SpoolPublisher]:
    """A :class:`SpoolPublisher` when ``fleetobs.spool.dir`` is set,
    else None.  Call AFTER ``obs.configure_from_config`` (the identity's
    trace anchor must describe the configured tracer) and BEFORE the
    flight recorder is configured — this routes ``flight.dump.dir``
    into the spool feed unless the job explicitly configured one."""
    spool = config.get(KEY_SPOOL_DIR)
    if not spool:
        return None
    pub = SpoolPublisher(spool, new_identity(config.get(KEY_ROLE) or role))
    if not config.get(flight.KEY_DUMP_DIR):
        config.set(flight.KEY_DUMP_DIR, pub.flight_dir)
    return pub
