"""Lease-based router leadership: one leader per spool, file-atomic.

N replicated ``python -m avenir_tpu_torch router`` processes share one
fleetobs spool (each dispatches independently — dispatch needs no
coordination), but exactly ONE may run the autoscale/residency control
loops, or N routers would fight over every ``scale`` decision.  The
election needs no new protocol: the lease is a single JSON file in the
spool (``<spool>/_router_lease`` — ``_``-prefixed, so feed scanners
skip it) replaced atomically with the temp+fsync+rename
discipline, holding the current holder's identity label, a per-process
nonce, a monotonically increasing **generation**, and renew/TTL stamps:

- the HOLDER renews in place every ``router.lease.renew.sec`` (default
  ttl/3), carrying its generation forward;
- a CONTENDER touches the file only when the lease is absent or has
  not been renewed within ``router.lease.ttl.sec``: it writes
  ``generation + 1`` under its own nonce, waits a settle beat, and
  claims leadership only if the read-back still shows that nonce
  (atomic rename makes concurrent claims last-writer-wins; the loser
  reads a foreign nonce and stays a follower) — so a SIGKILLed leader
  is replaced within one TTL plus one renew tick;
- a holder that reads a foreign nonce STEPS DOWN immediately: its file
  was superseded (e.g. it stalled past TTL and a sibling promoted).

Rename alone cannot give perfect mutual exclusion — two contenders can
overlap for at most one settle window before the file converges.  What
makes the overlap harmless is the generation FENCE: every scale command
the control loop issues carries the lease generation, and the backend
pool refuses any command below the highest generation it has applied
per model (serve/pool.py) — a deposed leader's in-flight decision
cannot fight the new leader's.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Optional

from ...core import flight, sanitizer
from ...core.io import atomic_write_text

KEY_LEASE_TTL = "router.lease.ttl.sec"
KEY_LEASE_RENEW = "router.lease.renew.sec"

DEFAULT_LEASE_TTL = 5.0

#: the lease file at the spool root; RESERVED_PREFIX ("_") keeps it out
#: of fleetobs.stitch.feed_dirs
LEASE_FILE = "_router_lease"

#: contender settle window: write, wait this long, read back — bounds
#: the dual-claim overlap of two simultaneous contenders
SETTLE_SEC = 0.05

THREAD_NAME = "avenir-fleet-lease"


class RouterLease:
    """One router process's view of the shared leadership lease."""

    def __init__(self, config, spool_dir: str, label: str):
        self.ttl = max(0.2, config.get_float(KEY_LEASE_TTL,
                                             DEFAULT_LEASE_TTL))
        renew = config.get_float(KEY_LEASE_RENEW, 0.0)
        self.renew_sec = renew if renew > 0 else max(0.1, self.ttl / 3.0)
        self.path = os.path.join(spool_dir, LEASE_FILE)
        self.label = label
        self.nonce = uuid.uuid4().hex
        self._lock = sanitizer.make_lock("fleet.lease")
        self._leader = False
        self._generation = 0
        self._holder: Optional[str] = None
        self.acquisitions = 0
        self.step_downs = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the read surface ---------------------------------------------------
    def is_leader(self) -> bool:
        with self._lock:
            return self._leader

    def generation(self) -> int:
        """The lease generation LAST OBSERVED (as holder or follower) —
        what the control loop stamps on scale commands."""
        with self._lock:
            return self._generation

    def section(self) -> dict:
        with self._lock:
            return {"leader": self._leader, "holder": self._holder,
                    "generation": self._generation,
                    "ttl_sec": self.ttl, "renew_sec": self.renew_sec,
                    "acquisitions": self.acquisitions,
                    "step_downs": self.step_downs}

    # -- the file protocol --------------------------------------------------
    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None        # absent, or torn on a non-atomic-rename fs

    def _write(self, generation: int, acquired: float,
               renewed: float) -> None:
        atomic_write_text(self.path, json.dumps(
            {"holder": self.label, "nonce": self.nonce,
             "generation": int(generation),
             "acquired_unix": float(acquired),
             "renewed_unix": float(renewed),
             "ttl_sec": self.ttl}) + "\n")

    def _expired(self, doc: dict, now: float) -> bool:
        try:
            renewed = float(doc.get("renewed_unix", 0.0))
        except (TypeError, ValueError):
            return True
        return now - renewed > self.ttl

    def tick(self, now: Optional[float] = None) -> bool:
        """One lease step — renew, follow, or contend.  Returns the
        leadership bit after the step."""
        now = time.time() if now is None else float(now)
        doc = self._read()
        if doc is not None and doc.get("nonce") == self.nonce:
            # ours: renew in place, generation carried forward
            gen = int(doc.get("generation", self._generation) or 0)
            self._write(gen, float(doc.get("acquired_unix", now) or now),
                        now)
            return self._transition(True, gen, self.label)
        if doc is not None and not self._expired(doc, now):
            # live foreign lease: follow it (and track its generation,
            # so a later promotion starts fencing from the right floor)
            return self._transition(False,
                                    int(doc.get("generation", 0) or 0),
                                    doc.get("holder"))
        # absent or expired: contend with generation + 1
        gen = (int(doc.get("generation", 0) or 0)
               if doc is not None else 0) + 1
        self._write(gen, now, now)
        if SETTLE_SEC > 0:
            self._stop.wait(SETTLE_SEC)
        chk = self._read()
        if chk is not None and chk.get("nonce") == self.nonce:
            return self._transition(True, gen, self.label)
        # a simultaneous contender out-renamed us: follow whoever won
        return self._transition(
            False,
            int((chk or {}).get("generation", gen) or gen),
            (chk or {}).get("holder"))

    def _transition(self, leader: bool, generation: int,
                    holder) -> bool:
        with self._lock:
            was = self._leader
            self._leader = leader
            self._generation = int(generation)
            self._holder = str(holder) if holder is not None else None
            if leader and not was:
                self.acquisitions += 1
            elif was and not leader:
                self.step_downs += 1
        if leader and not was:
            flight.record("fleet.lease_acquired", holder=self.label,
                          generation=int(generation))
        elif was and not leader:
            flight.record("fleet.lease_lost", holder=self.label,
                          generation=int(generation))
        return leader

    def release(self) -> None:
        """Clean hand-off (SIGTERM path): expire our own lease
        (``renewed_unix=0``) so a follower promotes on its next tick
        instead of waiting out the TTL.  A SIGKILLed leader never gets
        here — that is what the TTL is for."""
        doc = self._read()
        if doc is None or doc.get("nonce") != self.nonce:
            return
        atomic_write_text(self.path, json.dumps(
            {"holder": self.label, "nonce": self.nonce,
             "generation": int(doc.get("generation", 0) or 0),
             "acquired_unix": doc.get("acquired_unix", 0.0),
             "renewed_unix": 0.0, "ttl_sec": self.ttl}) + "\n")
        self._transition(False, int(doc.get("generation", 0) or 0), None)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RouterLease":
        if self._thread is not None:
            return self
        try:
            self.tick()     # leadership settles before the first
        except OSError:     # control tick, not one renew period later
            pass

        def run():
            while not self._stop.wait(self.renew_sec):
                try:
                    self.tick()
                except Exception:                       # noqa: BLE001
                    pass    # one bad tick must not kill the lease loop

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
        try:
            self.release()
        except OSError:
            pass            # spool already gone on teardown


__all__ = ["RouterLease", "LEASE_FILE", "KEY_LEASE_TTL",
           "KEY_LEASE_RENEW"]
