"""Process identity records: who published this spool feed.

A fleet merge erases process boundaries by construction (that is its
job), so attribution has to ride ALONGSIDE the merged state: every
spool feed carries one identity record — role (which entry point),
host, pid, and a start-time nonce so a restarted process with a
recycled pid publishes under a FRESH feed instead of silently
continuing the dead one's series — plus the tracer's wall-clock epoch
anchor, which is what lets the stitcher place N processes' relative
span timestamps on one shared timeline.
"""

from __future__ import annotations

import os
import re
import socket
import time
from typing import Mapping, Optional

from ..core import obs

#: spool entries starting with this prefix are aggregator-owned
#: (incident bundles, the aggregator's own flight dir), never feeds
RESERVED_PREFIX = "_"

_LABEL_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")


class ProcessIdentity:
    """One publishing process's identity: ``label`` is its spool
    directory name — filesystem-safe and unique per process START
    (role, host, pid, and a nanosecond start nonce), so two publishers
    can never collide and a restart never aliases its predecessor."""

    __slots__ = ("role", "host", "pid", "start_ns", "trace_epoch_unix_ns")

    def __init__(self, role: str, host: str, pid: int, start_ns: int,
                 trace_epoch_unix_ns: int):
        self.role = str(role)
        self.host = str(host)
        self.pid = int(pid)
        self.start_ns = int(start_ns)
        self.trace_epoch_unix_ns = int(trace_epoch_unix_ns)

    @property
    def label(self) -> str:
        nonce = format(self.start_ns & 0xFFFFFFFFFF, "x")
        return "-".join(_LABEL_SAFE_RE.sub("_", part)
                        for part in (self.role, self.host, str(self.pid),
                                     nonce))

    def to_dict(self) -> dict:
        return {"role": self.role, "host": self.host, "pid": self.pid,
                "start_ns": self.start_ns, "label": self.label,
                "trace_epoch_unix_ns": self.trace_epoch_unix_ns}

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "ProcessIdentity":
        return cls(role=str(d["role"]), host=str(d["host"]),
                   pid=int(d["pid"]), start_ns=int(d["start_ns"]),
                   trace_epoch_unix_ns=int(d.get("trace_epoch_unix_ns", 0)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ProcessIdentity({self.label})"


def new_identity(role: str, tracer: Optional[object] = None
                 ) -> ProcessIdentity:
    """This process's identity record.  Build it AFTER the tracer is
    configured (``obs.configure_from_config``) — the wall-clock anchor
    must describe the tracer whose records actually get spooled."""
    tr = tracer if tracer is not None else obs.get_tracer()
    return ProcessIdentity(
        role=role, host=socket.gethostname(), pid=os.getpid(),
        start_ns=time.time_ns(),
        trace_epoch_unix_ns=tr.wall_epoch_unix_ns())
