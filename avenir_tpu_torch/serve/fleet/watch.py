"""Feed watch: the router's SLO-and-residency eyes on the spool.

The fleetobs plane makes every backend publish an
atomic ``snapshot.json`` into its spool feed; this module consumes
those feeds AS A LIBRARY — no aggregator process required — and folds
each backend's RAW per-process snapshot into a rolling per-backend
:class:`~avenir_tpu_torch.fleetobs.aggregate.FleetSLO` view.  Per poll tick,
for every backend the watch knows:

- **binding**: which feed belongs to which configured backend, matched
  through the ``serve.frontend.port`` gauge each serving process
  publishes (labels carry host+pid, but the port is what the router
  dials);
- **staleness**: feed age vs ``router.feed.stale.sec`` — a dead or
  wedged backend stops publishing before it stops accepting, so
  staleness demotes it in the dispatch ladder ahead of request
  failures;
- **per-model SLO verdicts**: the same rolling-window code that
  watches a single process, evaluated per backend, plus the backend's
  own soft-degrade gauges;
- **residency + replica count**: which models the backend currently
  serves (``serve.e2e.latency{model=}`` histogram presence) and at how
  many replicas (``serve.replica.worker.alive`` gauges) — the
  residency-coordination and autoscale inputs.

The poll thread is named ``avenir-fleet-watch`` and joined on stop.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ...core import sanitizer, telemetry
from ...fleetobs.aggregate import E2E_FAMILY, FleetSLO, parse_labels
from ...fleetobs.publisher import SNAPSHOT_FILE
from ...fleetobs.stitch import feed_dirs

KEY_POLL_SEC = "router.poll.sec"
KEY_FEED_STALE_SEC = "router.feed.stale.sec"

DEFAULT_POLL_SEC = 1.0
DEFAULT_FEED_STALE_SEC = 10.0

#: the binding gauge a serving process publishes (serve/server.py)
PORT_GAUGE = "serve.frontend.port"
DEGRADED_GAUGE = "serve.breaker.soft.degraded"
REPLICA_GAUGE = "serve.replica.worker.alive"

THREAD_NAME = "avenir-fleet-watch"


class BackendView:
    """One backend's last-observed feed state."""

    __slots__ = ("name", "label", "published_unix", "seq", "stale",
                 "resident", "degraded", "replicas", "verdicts",
                 "tripped", "quarantine")

    def __init__(self, name: str):
        self.name = name
        self.label: Optional[str] = None
        self.published_unix = 0.0
        self.seq = 0
        self.stale = False
        self.resident: set = set()
        self.degraded: set = set()
        self.replicas: Dict[str, int] = {}
        self.verdicts: Dict[str, dict] = {}
        # from the snapshot's `resilience` section: models whose breaker
        # is OPEN on this backend, and its quarantined poison signatures
        self.tripped: set = set()
        self.quarantine: Dict[str, Dict[str, int]] = {}

    def section(self) -> dict:
        return {"label": self.label, "seq": self.seq,
                "stale": self.stale,
                "resident": sorted(self.resident),
                "degraded": sorted(self.degraded),
                "replicas": dict(self.replicas),
                "tripped": sorted(self.tripped),
                "quarantined": {m: len(s)
                                for m, s in self.quarantine.items()},
                "slo": self.verdicts}


def _parse_snapshot(snap: dict) -> dict:
    """Pull the routing-relevant facts out of one RAW feed snapshot."""
    gauges = snap.get("gauges") or {}
    port = None
    degraded = set()
    replicas: Dict[str, set] = {}
    for name, g in gauges.items():
        m = telemetry._LABELED_RE.match(name)
        family = m.group(1) if m else name
        labels = parse_labels(m.group(2)) if m else {}
        try:
            value = float((g or {}).get("value", 0.0))
        except (TypeError, ValueError):
            continue
        if family == PORT_GAUGE:
            port = int(value)
        elif family == DEGRADED_GAUGE and value >= 1.0:
            model = labels.get("model")
            if model:
                degraded.add(model)
        elif family == REPLICA_GAUGE:
            model = labels.get("model")
            if model:
                replicas.setdefault(model, set()).add(
                    labels.get("replica", "0"))
    resident = set()
    for name in (snap.get("hists") or {}):
        m = telemetry._LABELED_RE.match(name)
        if m and m.group(1) == E2E_FAMILY:
            model = parse_labels(m.group(2)).get("model")
            if model:
                resident.add(model)
    res = snap.get("resilience") or {}
    tripped = {m for m, code in (res.get("breakers") or {}).items()
               if int(code or 0) >= 2}        # 2 = OPEN (breaker.py)
    quarantine = {m: {str(s): int(n or 0) for s, n in (sigs or {}).items()}
                  for m, sigs in (res.get("quarantine") or {}).items()
                  if sigs}
    return {"port": port, "degraded": degraded, "resident": resident,
            "replicas": {k: len(v) for k, v in replicas.items()},
            "tripped": tripped, "quarantine": quarantine}


class FeedWatch:
    """Poll thread mapping spool feeds onto configured backends."""

    def __init__(self, config, spool_dir: str, backend_names: List[str]):
        self.config = config
        self.spool_dir = spool_dir
        self.poll_sec = config.get_float(KEY_POLL_SEC, DEFAULT_POLL_SEC)
        self.stale_sec = config.get_float(KEY_FEED_STALE_SEC,
                                          DEFAULT_FEED_STALE_SEC)
        self._port_to_name = {int(n.rsplit(":", 1)[1]): n
                              for n in backend_names}
        self._views: Dict[str, BackendView] = {
            n: BackendView(n) for n in backend_names}
        self._slo: Dict[str, FleetSLO] = {}
        self._fleet_tripped: set = set()
        self._lock = sanitizer.make_lock("fleet.watch")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scans = 0

    # -- polling -----------------------------------------------------------
    def scan(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else float(now)
        observed = []          # (name, snapshot) to evaluate off-lock
        with self._lock:
            for d in feed_dirs(self.spool_dir):
                try:
                    with open(os.path.join(d, SNAPSHOT_FILE)) as fh:
                        doc = json.load(fh)
                except (OSError, ValueError):
                    continue    # not yet published / torn on a weird fs
                snap = doc.get("snapshot")
                if not isinstance(snap, dict):
                    continue
                facts = _parse_snapshot(snap)
                name = self._port_to_name.get(facts["port"] or -1)
                if name is None:
                    continue    # a feed of some other process (router,
                                # workload, a backend not ours)
                view = self._views[name]
                view.label = str(doc.get("label") or "")
                view.seq = int(doc.get("seq", 0))
                view.published_unix = float(
                    doc.get("published_unix", 0.0))
                view.resident = facts["resident"]
                view.degraded = facts["degraded"]
                view.replicas = facts["replicas"]
                view.tripped = facts["tripped"]
                view.quarantine = facts["quarantine"]
                observed.append((name, snap))
            for view in self._views.values():
                view.stale = (view.published_unix > 0
                              and now - view.published_unix
                              > self.stale_sec)
            # the fleet-wide pre-demote set: a model whose breaker is
            # OPEN on ANY fresh sibling — the trip is likely systemic
            # (a poisoned artifact trips everywhere it lands), so the
            # healthy rung stops vouching for the model ANYWHERE before
            # the other backends fail their own way into it
            self._fleet_tripped = {
                m for v in self._views.values()
                if not v.stale for m in v.tripped}
            self.scans += 1
        for name, snap in observed:
            with self._lock:
                slo = self._slo.get(name)
                if slo is None:
                    slo = self._slo[name] = FleetSLO(self.config)
            # fold OFF the lock: window math must not block healthy()
            slo.observe(snap)
            verdicts = slo.verdicts()
            with self._lock:
                self._views[name].verdicts = verdicts

    # -- the router's read surface ----------------------------------------
    def healthy(self, name: str, model: Optional[str] = None) -> bool:
        """Dispatch-grade health: the backend's feed is fresh, the model
        is not soft-degraded (or breaker-tripped) there, and its rolling
        window is not in violation.  A backend never observed yet is
        OPTIMISTICALLY healthy — feeds lag process start, and a cold
        fleet must still route (mirrors the variant router's no-data
        optimism).  A model breaker-tripped on ANY fresh sibling is
        pre-demoted FLEET-WIDE (the healthy rung empties for it, so the
        ladder falls to the connected rung rather than keep vouching
        for a likely-systemic failure)."""
        with self._lock:
            if model is not None and model in self._fleet_tripped:
                return False
            view = self._views.get(name)
            if view is None or view.published_unix == 0:
                return True
            if view.stale:
                return False
            if model is not None:
                if model in view.degraded or model in view.tripped:
                    return False
                verdict = view.verdicts.get(model)
                if verdict is not None and not verdict.get("ok", True):
                    return False
            return True

    def residency(self, model: str) -> List[str]:
        """Backends whose feed shows the model resident, fresh feeds
        first (a stale feed's residency claim is history, not state)."""
        with self._lock:
            fresh = [v.name for v in self._views.values()
                     if not v.stale and model in v.resident]
            return sorted(fresh)

    def replicas(self, model: str) -> Dict[str, int]:
        with self._lock:
            return {v.name: v.replicas.get(model, 0)
                    for v in self._views.values()
                    if model in v.replicas}

    def fleet_tripped(self, model: str) -> bool:
        """True when ANY fresh sibling's feed shows the model's breaker
        open — the fleet-wide pre-demote bit."""
        with self._lock:
            return model in self._fleet_tripped

    def quarantine_sightings(self) -> Dict[str, Dict[str, int]]:
        """Fleet union of quarantined poison signatures across FRESH
        feeds (per model, per signature, max offenses) — the
        propagation pump's input (control.py): what any one backend
        quarantined, every sibling should refuse at submit."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for v in self._views.values():
                if v.stale:
                    continue
                for model, sigs in v.quarantine.items():
                    dst = out.setdefault(model, {})
                    for sig, n in sigs.items():
                        dst[sig] = max(dst.get(sig, 0), n)
            return out

    def backend_quarantine(self, name: str) -> Dict[str, Dict[str, int]]:
        """One backend's own quarantined signatures as its feed last
        showed them — what the propagation pump diffs against so it
        only pushes signatures the backend demonstrably lacks."""
        with self._lock:
            view = self._views.get(name)
            if view is None:
                return {}
            return {m: dict(s) for m, s in view.quarantine.items()}

    def section(self) -> dict:
        with self._lock:
            return {"scans": self.scans,
                    "stale_sec": self.stale_sec,
                    "fleet_tripped": sorted(self._fleet_tripped),
                    "backends": {n: v.section()
                                 for n, v in sorted(self._views.items())}}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FeedWatch":
        if self.poll_sec <= 0 or self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.poll_sec):
                try:
                    self.scan()
                except Exception:                       # noqa: BLE001
                    pass        # one bad pass must not blind the router

        self._thread = threading.Thread(target=run, name=THREAD_NAME,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None
