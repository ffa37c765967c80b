"""The fleet aggregator: watch N spools, serve ONE merged surface.

``python -m avenir_tpu_torch fleetobs -Dfleetobs.spool.dir=<dir>`` polls
every feed under the spool, folds the per-process snapshots
(:func:`fleet_fold` — gauges namespaced per process, counters/hists
summed by the certified merge), drives fleet-level SLO boards from the
merged per-model histograms, and serves the result over the SAME
JSON-lines frontend the prediction server uses:

- ``{"cmd": "metrics"}`` — merged Prometheus exposition (``# EOF``
  terminated), scrapeable by :func:`serve.server.request_text`
- ``{"cmd": "health"}``  — ok iff no feed is stale; fleet SLO section
- ``{"cmd": "stats"}``   — per-feed detail (seq, age, staleness),
  fleet SLO windows, incident count

Feed staleness (a process died or stopped publishing) becomes a
``fleetobs.feed.stale{proc=...}`` gauge and, on the fresh→stale EDGE,
a flight-recorder anomaly dump — the aggregator's own black box
records what the fleet looked like when the feed went dark.  New
flight dumps in any feed are correlated into incident bundles
(:mod:`.incidents`).

Deliberately torch-free: the aggregator imports only the observability
substrate, so it can run beside N serving processes at the cost of an
OS process, not an accelerator runtime.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core import flight, sanitizer, telemetry
from ..core.config import load_job_config, parse_cli_args
from .aggregate import FleetSLO, fleet_fold
from .incidents import IncidentCorrelator
from .publisher import (FLIGHT_SUBDIR, KEY_SPOOL_DIR, SNAPSHOT_FILE,
                        SpoolPublisher)
from .stitch import feed_dirs, read_identity, stitch_traces

KEY_POLL_SEC = "fleetobs.poll.sec"
KEY_STALE_SEC = "fleetobs.stale.sec"
KEY_HOST = "fleetobs.host"
KEY_PORT = "fleetobs.port"
KEY_INCIDENT_DIR = "fleetobs.incident.dir"

DEFAULT_POLL_SEC = 1.0
DEFAULT_STALE_SEC = 10.0

#: thread-name prefix of the aggregator's poll thread (the shutdown
#: discipline: stop() joins it, mirroring telemetry.THREAD_PREFIXES)
THREAD_PREFIX = "avenir-fleetobs"


class _Feed:
    __slots__ = ("label", "dir", "identity", "snapshot", "seq",
                 "published_unix", "stale")

    def __init__(self, label: str, d: str, identity: dict):
        self.label = label
        self.dir = d
        self.identity = identity
        self.snapshot: Optional[dict] = None
        self.seq = 0
        self.published_unix = 0.0
        self.stale = False


class FleetAggregator:
    """Poll loop + merged surface.  Exposes ``dispatch_line`` /
    ``max_line_bytes`` so :class:`~avenir_tpu_torch.serve.frontend.
    EventLoopFrontend` can serve it unchanged."""

    max_line_bytes = 1 << 20

    def __init__(self, spool_dir: str, config):
        self.spool_dir = spool_dir
        self.poll_sec = config.get_float(KEY_POLL_SEC, DEFAULT_POLL_SEC)
        self.stale_sec = config.get_float(KEY_STALE_SEC, DEFAULT_STALE_SEC)
        incident_dir = (config.get(KEY_INCIDENT_DIR)
                        or os.path.join(spool_dir, "_incidents"))
        self.config = config
        self.fleet_slo = FleetSLO(config)
        # per-feed SLO boards: the same rolling-window evaluation the
        # fleet board runs on the merged snapshot, applied to each RAW
        # feed — machine-readable per-feed, per-model verdicts in
        # ``stats`` so routers and runbooks stop recomputing them
        self._feed_slo: Dict[str, FleetSLO] = {}
        self.incidents = IncidentCorrelator(incident_dir)
        self._feeds: Dict[str, _Feed] = {}
        self._lock = sanitizer.make_lock("fleetobs.aggregator")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scans = 0

    # -- polling -----------------------------------------------------------
    def scan(self, now: Optional[float] = None) -> dict:
        """One poll pass: refresh feeds, mark staleness edges (flight
        anomaly on fresh→stale), correlate new flight dumps, evaluate
        the fleet SLO boards.  Returns the merged fleet snapshot."""
        now = time.time() if now is None else float(now)
        with self._lock:
            for d in feed_dirs(self.spool_dir):
                label = os.path.basename(d)
                feed = self._feeds.get(label)
                if feed is None:
                    ident = read_identity(d)
                    if ident is None:
                        continue
                    feed = self._feeds[label] = _Feed(label, d, ident)
                self._refresh(feed)
            for feed in self._feeds.values():
                was = feed.stale
                feed.stale = (feed.published_unix > 0
                              and now - feed.published_unix
                              > self.stale_sec)
                if feed.stale and not was:
                    # edge-triggered: the moment a feed goes dark, dump
                    # the aggregator's black box naming it
                    flight.trigger(
                        "fleet_feed_stale", force=True, proc=feed.label,
                        age_sec=round(now - feed.published_unix, 3),
                        stale_sec=self.stale_sec)
            merged = self._fleet_snapshot(now)
            self.scans += 1
            snapshots = [(f.label, f.snapshot)
                         for f in self._feeds.values()
                         if f.snapshot is not None]
        for label, snap in snapshots:
            with self._lock:
                slo = self._feed_slo.get(label)
                if slo is None:
                    slo = self._feed_slo[label] = FleetSLO(self.config)
            # fold OFF the lock: window math must not block dispatch
            slo.observe(snap)
        dirs = {f.label: f.dir for f in self._feeds.values()}
        # the aggregator's own black box (feed-stale anomalies land in
        # the reserved _aggregator spool entry) correlates too — a feed
        # going dark should produce an incident, not just a gauge
        own = os.path.join(self.spool_dir, "_aggregator")
        if os.path.isdir(os.path.join(own, FLIGHT_SUBDIR)):
            dirs["_aggregator"] = own
        self.incidents.scan(dirs)
        self.fleet_slo.observe(merged)
        return merged

    def _refresh(self, feed: _Feed) -> None:
        try:
            with open(os.path.join(feed.dir, SNAPSHOT_FILE)) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return          # not yet published (or mid-replace on a
                            # non-atomic filesystem): keep the last one
        snap = doc.get("snapshot")
        if not isinstance(snap, dict):
            return
        feed.snapshot = snap
        feed.seq = int(doc.get("seq", 0))
        feed.published_unix = float(doc.get("published_unix", 0.0))

    def _fleet_snapshot(self, now: float) -> dict:
        """The fold + the aggregator's own fleet gauges.  Stale feeds
        STAY in the fold: their counters are cumulative history that
        still happened — staleness is surfaced, never silently
        subtracted."""
        merged = fleet_fold({f.label: f.snapshot
                             for f in self._feeds.values()
                             if f.snapshot is not None})
        g = merged.setdefault("gauges", {})

        def gauge(name, value, **labels):
            g[telemetry.labeled(name, **labels)] = {
                "value": float(value), "ts": now}

        live = [f for f in self._feeds.values() if f.snapshot is not None]
        gauge("fleetobs.feeds", len(live))
        gauge("fleetobs.feeds.stale", sum(1 for f in live if f.stale))
        for f in live:
            gauge("fleetobs.feed.stale", 1 if f.stale else 0,
                  proc=f.label)
            gauge("fleetobs.feed.age.sec",
                  round(max(now - f.published_unix, 0.0), 3),
                  proc=f.label)
        return merged

    def fleet_snapshot(self) -> dict:
        """The current merged snapshot (fresh fold over cached feeds —
        a scrape between polls sees the latest published state)."""
        now = time.time()
        with self._lock:
            return self._fleet_snapshot(now)

    # -- the JSON-lines surface -------------------------------------------
    def dispatch_line(self, line: str, cb: Callable[[dict], None],
                      conn=None) -> Optional[dict]:
        try:
            obj = json.loads(line)
            if not isinstance(obj, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            cb({"error": f"bad request: {exc}"})
            return None
        cmd = obj.get("cmd")
        try:
            if cmd == "metrics":
                cb({"_text": telemetry.prometheus_text(
                    self.fleet_snapshot())})
            elif cmd == "health":
                cb(self._health())
            elif cmd == "stats":
                cb(self._stats())
            else:
                cb({"error": f"unknown cmd: {cmd!r} "
                             f"(metrics|health|stats)"})
        except Exception as exc:                        # noqa: BLE001
            cb({"error": f"{type(exc).__name__}: {exc}"})
        return None

    def _health(self) -> dict:
        with self._lock:
            stale = sorted(f.label for f in self._feeds.values()
                           if f.stale)
            feeds = sum(1 for f in self._feeds.values()
                        if f.snapshot is not None)
        return {"ok": not stale, "feeds": feeds, "stale": stale,
                "slo": self.fleet_slo.section()}

    def _stats(self) -> dict:
        now = time.time()
        with self._lock:
            feeds = {f.label: {
                "role": f.identity.get("role"),
                "pid": f.identity.get("pid"),
                "seq": f.seq,
                "age_sec": (round(now - f.published_unix, 3)
                            if f.published_unix else None),
                "stale": f.stale,
                "slo": (self._feed_slo[f.label].verdicts()
                        if f.label in self._feed_slo else {}),
            } for f in sorted(self._feeds.values(),
                              key=lambda f: f.label)}
            scans = self.scans
        return {"feeds": feeds, "scans": scans,
                "slo": self.fleet_slo.section(),
                "slo_verdicts": self.fleet_slo.verdicts(),
                "incidents": self.incidents.bundled,
                "flight": flight.get_recorder().stats()}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetAggregator":
        if self.poll_sec <= 0 or self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.poll_sec):
                try:
                    self.scan()
                except Exception:                       # noqa: BLE001
                    pass        # one bad pass must not kill the plane

        self._thread = threading.Thread(target=run, name=THREAD_PREFIX,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None


def _stitch_main(argv) -> int:
    from ..cli import _extract_value_flag
    argv, trace_id = _extract_value_flag(list(argv), "--trace-id")
    argv, out_path = _extract_value_flag(argv, "--out")
    argv, spool = _extract_value_flag(argv, "--spool")
    defines, positional = parse_cli_args(argv)
    config = load_job_config(defines)
    spool = spool or config.get(KEY_SPOOL_DIR) or (
        positional[0] if positional else None)
    if not spool:
        print("fleetobs stitch: no spool "
              "(--spool <dir> or -Dfleetobs.spool.dir=<dir>)",
              file=sys.stderr)
        return 2
    out_path = out_path or "fleet-trace.json"
    n, labels = stitch_traces(spool, trace_id=trace_id, out_path=out_path)
    print(f"fleetobs: stitched {n} events from {len(labels)} "
          f"process(es) {labels} into {out_path} "
          f"(open in ui.perfetto.dev)", file=sys.stderr)
    return 0 if n else 1


def fleetobs_main(argv) -> int:
    """``python -m avenir_tpu_torch fleetobs [-Dfleetobs.spool.dir=<dir> ...]
    [--once]`` or ``... fleetobs stitch --trace-id X [--out f.json]``."""
    argv = list(argv)
    if argv and argv[0] == "stitch":
        return _stitch_main(argv[1:])
    once = "--once" in argv
    argv = [a for a in argv if a != "--once"]
    defines, positional = parse_cli_args(argv)
    config = load_job_config(defines)
    spool = config.get(KEY_SPOOL_DIR) or (
        positional[0] if positional else None)
    if not spool:
        print("fleetobs: no spool configured "
              "(-Dfleetobs.spool.dir=<dir>)", file=sys.stderr)
        return 2
    from ..cli import configure_resilience
    from ..core import obs
    obs.configure_from_config(config)
    # the aggregator's own flight dumps (feed-stale anomalies) default
    # into a reserved spool entry — never mistaken for a feed
    if not config.get(flight.KEY_DUMP_DIR):
        config.set(flight.KEY_DUMP_DIR,
                   os.path.join(spool, "_aggregator", FLIGHT_SUBDIR))
    configure_resilience(config)
    telemetry.configure_from_config(config)

    agg = FleetAggregator(spool, config)
    if once:
        merged = agg.scan()
        sys.stdout.write(telemetry.prometheus_text(merged))
        return 0
    agg.start()
    from ..serve.frontend import EventLoopFrontend
    frontend = EventLoopFrontend(
        agg, config.get(KEY_HOST, "127.0.0.1"),
        config.get_int(KEY_PORT, 0), io_threads=1)
    print(f"fleetobs: aggregating {spool} on "
          f"{config.get(KEY_HOST, '127.0.0.1')}:{frontend.port} "
          f"(poll {agg.poll_sec}s, stale after {agg.stale_sec}s)",
          file=sys.stderr, flush=True)
    stop_evt = threading.Event()
    import signal
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop_evt.set())
        except (ValueError, OSError):
            pass
    try:
        stop_evt.wait()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.stop()
        agg.stop()
        dump = flight.flush_on_exit()
        if dump:
            print(f"flight: wrote final black-box dump to {dump}",
                  file=sys.stderr)
    return 0


# referenced by __init__ re-exports and the runbook; kept here so the
# CLI branch imports one module
__all__ = ["FleetAggregator", "SpoolPublisher", "fleetobs_main"]
