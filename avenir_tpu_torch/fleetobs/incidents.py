"""Flight-dump correlation: one anomaly, one incident directory.

A flight dump is a single process's black box.  In a fleet the question
is almost never "what did THIS process see" but "what was everyone
doing when it happened" — so when any feed's ``flight/`` directory
grows a new dump, the aggregator bundles, into ONE incident directory:

- every sibling dump (across ALL feeds) whose ``flight.header`` carries
  the same trace id,
- each contributing feed's trace tail for that trace id
  (``<label>-trace.jsonl``), and
- a ``manifest.json`` naming the trigger, the members, and the feeds.

Dumps are keyed by their header's ``trace_id`` — the first line of the
dump file — never by parsing the filename back (the filename tag
doubles as a timestamp when the trigger carried no trace).  An
untraced dump still gets an incident directory (keyed by its file
stem) so no black box is ever orphaned; it just has nothing to
correlate.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

from ..core import flight
from ..core.io import atomic_write_text
from .publisher import FLIGHT_SUBDIR
from .stitch import trace_tail

_NAME_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")


def _dumps_in(feed_dir: str) -> List[str]:
    d = os.path.join(feed_dir, FLIGHT_SUBDIR)
    try:
        return sorted(os.path.join(d, n) for n in os.listdir(d)
                      if n.startswith("flight-") and n.endswith(".jsonl"))
    except OSError:
        return []


class IncidentCorrelator:
    """Tracks seen dumps across feeds; ``scan`` turns new ones into
    incident bundles under ``incident_dir`` (created lazily)."""

    def __init__(self, incident_dir: str, tail_limit: int = 2000):
        self.incident_dir = incident_dir
        self.tail_limit = int(tail_limit)
        self._seen: set = set()
        self.bundled = 0

    def scan(self, feed_dirs_by_label: Dict[str, str]) -> List[str]:
        """One correlation pass; returns incident directories created
        or refreshed this pass."""
        fresh: List[Tuple[str, str, Optional[dict]]] = []
        for label, d in sorted(feed_dirs_by_label.items()):
            for path in _dumps_in(d):
                if path in self._seen:
                    continue
                self._seen.add(path)
                fresh.append((label, path, flight.read_dump_header(path)))
        out: List[str] = []
        done_keys: set = set()
        for label, path, header in fresh:
            trace_id = (header or {}).get("trace_id")
            key = (str(trace_id) if trace_id
                   else os.path.splitext(os.path.basename(path))[0])
            if key in done_keys:
                continue        # a sibling already bundled this pass
            done_keys.add(key)
            out.append(self._bundle(key, trace_id, (label, path),
                                    feed_dirs_by_label))
        return out

    def _bundle(self, key: str, trace_id: Optional[str],
                trigger: Tuple[str, str],
                feed_dirs_by_label: Dict[str, str]) -> str:
        inc_dir = os.path.join(self.incident_dir,
                               f"incident-{_NAME_SAFE_RE.sub('_', key)}")
        os.makedirs(inc_dir, exist_ok=True)
        members: List[dict] = []
        for label, d in sorted(feed_dirs_by_label.items()):
            feed_dumps = []
            for path in _dumps_in(d):
                header = flight.read_dump_header(path)
                if trace_id is not None:
                    if (header or {}).get("trace_id") != trace_id:
                        continue
                elif path != trigger[1]:
                    continue    # untraced: bundle only the trigger dump
                self._seen.add(path)    # siblings need no own incident
                dst = os.path.join(inc_dir,
                                   f"{label}-{os.path.basename(path)}")
                try:
                    shutil.copy2(path, dst)
                except OSError:
                    continue
                feed_dumps.append({"feed": label, "dump": dst,
                                   "reason": (header or {}).get("reason")})
            if feed_dumps:
                members.extend(feed_dumps)
            if trace_id is not None:
                tail = trace_tail(d, str(trace_id), self.tail_limit)
                if tail:
                    tail_path = os.path.join(inc_dir,
                                             f"{label}-trace.jsonl")
                    atomic_write_text(tail_path, "".join(
                        json.dumps(r) + "\n" for r in tail))
                    members.append({"feed": label, "trace_tail": tail_path,
                                    "records": len(tail)})
        atomic_write_text(
            os.path.join(inc_dir, "manifest.json"),
            json.dumps({"incident": key, "trace_id": trace_id,
                        "trigger": {"feed": trigger[0],
                                    "dump": trigger[1]},
                        "members": members}, indent=2) + "\n")
        self.bundled += 1
        return inc_dir
