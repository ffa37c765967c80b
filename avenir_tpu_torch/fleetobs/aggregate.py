"""The fleet fold: N per-process snapshots into ONE, without lies.

``merge_snapshots`` is already a certified commutative fold — counters
sum, histogram buckets add, span summaries count-weight — so the only
genuinely fleet-specific problem is GAUGES: they merge
latest-timestamp-wins, which is correct inside one process (two samples
of the same series) and silently wrong across processes (two processes'
``device.hbm.bytes`` are two different devices, not two samples of
one).  The fix is namespacing, applied HERE, at the fleet boundary:
every gauge name gains a ``proc="<identity label>"`` label before the
fold, so per-process series survive side by side and latest-ts-wins
never sees two processes under one name.  Single-process callers never
pass through this module, so single-process merge behavior stays
byte-identical (asserted in tests/test_fleetobs.py).

:class:`FleetSLO` drives a regular :class:`~avenir_tpu_torch.serve.slo.SLOBoard`
from the merged per-model ``serve.e2e.latency{model=...}`` histograms
through the :class:`~avenir_tpu_torch.serve.slo.SnapshotStats` facade — the
fleet p99 is computed by the SAME rolling-window code that watches a
single process.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

from ..core import telemetry
from ..serve.slo import SLOBoard, SnapshotStats

#: merged-hist family the fleet SLO watches (the serve overlay's name)
E2E_FAMILY = "serve.e2e.latency"

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_UNESC_RE = re.compile(r"\\(.)")


def parse_labels(label_str: str) -> Dict[str, str]:
    """Inverse of :func:`telemetry.labeled`'s label rendering: the
    ``k="v"`` pairs with escapes undone."""
    out: Dict[str, str] = {}
    for m in _LABEL_RE.finditer(label_str):
        out[m.group(1)] = _UNESC_RE.sub(
            lambda e: {"n": "\n"}.get(e.group(1), e.group(1)), m.group(2))
    return out


def namespace_gauges(snap: Mapping[str, object], label: str) -> dict:
    """A shallow copy of ``snap`` whose every gauge name carries
    ``proc="<label>"`` (appended to existing labels) — the fleet-merge
    precondition that keeps latest-ts-wins from clobbering two
    processes' like-named gauges.  Counters/hists/spans are untouched:
    their merges are sums, where folding across processes is the POINT
    (fleet requests == sum of per-process requests)."""
    out = dict(snap)
    esc = telemetry._esc(str(label))
    named = {}
    for name, g in (snap.get("gauges") or {}).items():
        if name.endswith("}"):
            named[f'{name[:-1]},proc="{esc}"}}'] = g
        else:
            named[f'{name}{{proc="{esc}"}}'] = g
    out["gauges"] = named
    return out


def fleet_fold(snapshots_by_label: Mapping[str, dict]) -> dict:
    """Fold per-process snapshots (keyed by identity label) into one
    fleet snapshot: gauges namespaced per process first, then the
    certified ``merge_snapshots`` fold.  Identity/pid sections are
    consumed here and dropped, per SNAPSHOT_NON_MERGED."""
    merged: Optional[dict] = None
    for label in sorted(snapshots_by_label):
        ns = namespace_gauges(snapshots_by_label[label], label)
        merged = ns if merged is None else telemetry.merge_snapshots(
            merged, ns)
    if merged is None:
        return {"v": telemetry.SNAPSHOT_VERSION, "ts": 0.0, "mono": 0.0,
                "counters": {}, "gauges": {}, "hists": {}, "spans": {}}
    for section in telemetry.SNAPSHOT_NON_MERGED:
        merged.pop(section, None)
    return merged


class FleetSLO:
    """Fleet-level SLO boards over a merged snapshot.  One monitor per
    model parsed out of the merged ``serve.e2e.latency{model=...}``
    histograms; each keeps a stable :class:`SnapshotStats` facade so the
    rolling window survives across observations (ModelSLO keys its
    window on histogram identity)."""

    def __init__(self, config):
        self.board = SLOBoard(config)
        self._stats: Dict[str, SnapshotStats] = {}

    def observe(self, merged: dict) -> Dict[str, dict]:
        """Evaluate every model found in ``merged``; returns the window
        stats per model (also retained on the board for ``section``)."""
        out: Dict[str, dict] = {}
        counters = merged.get("counters") or {}
        for name, st in sorted((merged.get("hists") or {}).items()):
            m = telemetry._LABELED_RE.match(name)
            if not m or m.group(1) != E2E_FAMILY:
                continue
            model = parse_labels(m.group(2)).get("model")
            if not model:
                continue
            sv = self._stats.get(model)
            if sv is None:
                sv = self._stats[model] = SnapshotStats()
            sv.update(st, counters.get(f"Serve.{model}", {}))
            out[model] = self.board.observe(model, sv, config_name=model)
        return out

    def section(self) -> Dict[str, dict]:
        return self.board.section()

    def verdicts(self) -> Dict[str, dict]:
        """Machine-readable per-model SLO verdict from the LAST
        evaluation — the router tier's routing input and the aggregator
        ``stats`` surface, so runbooks stop recomputing it from merged
        histograms.  ``ok`` is the dispatch-grade bit: False the moment
        the window violates (the sustained bit additionally marks the
        degrade-grade signal)."""
        out: Dict[str, dict] = {}
        for model, stats in self.board.section().items():
            out[model] = {
                "ok": not (stats.get("violation")
                           or stats.get("sustained")),
                "p99_ms": stats.get("p99_ms"),
                "target_p99_ms": stats.get("target_p99_ms"),
                "error_pct": stats.get("error_pct"),
                "violation": bool(stats.get("violation")),
                "sustained": bool(stats.get("sustained")),
                "n": stats.get("n", 0),
            }
        return out
