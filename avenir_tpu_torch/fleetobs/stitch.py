"""Cross-process trace stitching: N spool feeds, ONE Perfetto file.

Each process's trace JSONL records timestamps relative to its OWN
tracer epoch (a ``perf_counter_ns`` instant, meaningless outside the
process).  The identity record carries that epoch expressed on the Unix
wall clock (``trace_epoch_unix_ns``), so stitching is pure arithmetic:
pick the earliest anchor across the selected feeds as t=0, offset every
record by ``(feed anchor - t0) + t0_ns``, and emit Chrome
``trace_event`` JSON with one ``pid`` lane per process (process_name =
the identity label).  The batcher's fan-in links (trace ids + explicit
parent span ids in ``args``) make a request's spans connect across
lanes in Perfetto.

``--trace-id X`` filters to span records whose attrs carry that trace
id — the "show me THIS request across the fleet" view; without it,
every record from every feed lands on the shared timeline.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

from ..core.io import atomic_write_text
from .identity import RESERVED_PREFIX
from .publisher import IDENTITY_FILE, TRACE_FILE


def feed_dirs(spool_dir: str) -> List[str]:
    """Every feed directory under the spool (has an identity.json;
    aggregator-reserved ``_*`` entries excluded), sorted by label."""
    out = []
    try:
        entries = sorted(os.listdir(spool_dir))
    except OSError:
        return []
    for name in entries:
        if name.startswith(RESERVED_PREFIX):
            continue
        d = os.path.join(spool_dir, name)
        if os.path.isfile(os.path.join(d, IDENTITY_FILE)):
            out.append(d)
    return out


def read_identity(feed_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(feed_dir, IDENTITY_FILE)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def read_trace_records(feed_dir: str) -> List[dict]:
    """The feed's flushed tracer records, oldest first: rotations
    (``trace.jsonl.N`` … ``trace.jsonl.1``) then the live file.
    Truncated tail lines (a crash mid-append) are skipped."""
    base = os.path.join(feed_dir, TRACE_FILE)
    paths = sorted(
        (p for p in glob.glob(base + ".*")
         if p.rsplit(".", 1)[1].isdigit()),
        key=lambda p: -int(p.rsplit(".", 1)[1]))
    paths.append(base)
    records: List[dict] = []
    for path in paths:
        try:
            with open(path) as fh:
                for line in fh:
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return records


def _matches(rec: dict, trace_id: Optional[str]) -> bool:
    if trace_id is None:
        return True
    if rec.get("type") != "span":
        return False
    return str((rec.get("attrs") or {}).get("trace")) == str(trace_id)


def stitch_traces(spool_dir: str, trace_id: Optional[str] = None,
                  out_path: str = "fleet-trace.json"
                  ) -> Tuple[int, List[str]]:
    """Merge every feed's trace JSONL onto one wall-clock timeline;
    returns ``(events written, labels of processes contributing
    events)``.  Feeds publishing no matching record get no lane."""
    feeds = []
    for d in feed_dirs(spool_dir):
        ident = read_identity(d)
        if ident is None or not ident.get("trace_epoch_unix_ns"):
            continue
        recs = [r for r in read_trace_records(d) if _matches(r, trace_id)]
        if recs:
            feeds.append((ident, recs))
    if not feeds:
        atomic_write_text(out_path, json.dumps(
            {"traceEvents": [], "displayTimeUnit": "ms"}))
        return 0, []

    t0 = min(int(ident["trace_epoch_unix_ns"]) for ident, _ in feeds)
    events: List[dict] = []
    labels: List[str] = []
    for lane, (ident, recs) in enumerate(sorted(
            feeds, key=lambda f: f[0].get("label", "")), start=1):
        label = str(ident.get("label", f"proc-{lane}"))
        labels.append(label)
        offset_ns = int(ident["trace_epoch_unix_ns"]) - t0
        events.append({"ph": "M", "name": "process_name", "pid": lane,
                       "tid": 0, "args": {"name": label}})
        tid_map: Dict[str, int] = {}

        def tid_of(thread_name: str) -> int:
            t = tid_map.get(thread_name)
            if t is None:
                t = tid_map[thread_name] = len(tid_map) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": lane, "tid": t,
                               "args": {"name": thread_name}})
            return t

        for r in recs:
            if r.get("type") == "span":
                events.append({
                    "name": r.get("name"), "cat": "avenir", "ph": "X",
                    "ts": (offset_ns + int(r.get("t0_ns", 0))) / 1000.0,
                    "dur": int(r.get("dur_ns", 0)) / 1000.0,
                    "pid": lane,
                    "tid": tid_of(str(r.get("thread", "main"))),
                    "args": {"id": r.get("id"), "parent": r.get("parent"),
                             "proc": label, **(r.get("attrs") or {})}})
            elif r.get("type") == "gauge":
                events.append({
                    "name": r.get("name"), "cat": "avenir", "ph": "C",
                    "ts": (offset_ns + int(r.get("t_ns", 0))) / 1000.0,
                    "pid": lane, "args": {"value": r.get("value")}})

    events.sort(key=lambda e: e.get("ts", -1.0))
    atomic_write_text(out_path, json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}))
    return len(events), labels


def trace_tail(feed_dir: str, trace_id: str, limit: int = 2000
               ) -> List[dict]:
    """The LAST ``limit`` records in a feed's trace JSONL that belong to
    ``trace_id`` — the incident correlator's per-process evidence."""
    recs = [r for r in read_trace_records(feed_dir)
            if _matches(r, trace_id)]
    return recs[-limit:]
