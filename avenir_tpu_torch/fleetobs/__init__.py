"""Fleet observability plane: the port's copy of ``avenir_tpu/fleetobs``.

Cross-process telemetry aggregation, stitched traces and fleet-wide SLO
verdicts, folded from the per-process state every primitive of the
observability substrate already keeps mergeable (``merge_snapshots``,
cumulative histograms, trace ids through batching fan-in).

- **Publisher** (:mod:`.publisher`) — with ``fleetobs.spool.dir`` set,
  every long-running entry point (serve, stream, workload, router)
  atomically publishes its ``TelemetryExporter`` snapshot per tick into
  a per-process spool directory, tagged with a process identity record
  (:mod:`.identity`: role, host, pid, start-time nonce, trace epoch
  anchor); incremental trace JSONL and flight dumps land in the same
  spool.
- **Aggregator** (:mod:`.aggregator`) — ``python -m avenir_tpu_torch
  fleetobs`` watches N spools, folds the snapshots (per-process gauges
  namespaced with the identity label — :mod:`.aggregate`), drives
  fleet-level ``SLOBoard``s from the merged per-model histograms,
  serves the merged Prometheus exposition + ``health``/``stats`` over
  the JSON-lines frontend, and turns feed staleness into a gauge plus a
  flight-recorder anomaly.
- **Trace stitching + flight correlation** (:mod:`.stitch`,
  :mod:`.incidents`) — ``python -m avenir_tpu_torch fleetobs stitch
  --trace-id X`` merges per-process trace JSONL into ONE
  Perfetto-loadable file with one lane per process; a flight dump in
  any process makes the aggregator bundle sibling-spool dumps and trace
  tails sharing the trace id into a single incident directory.

The aggregator is deliberately torch-free: it imports only the core
observability substrate, so one more aggregator process costs an OS
process, not a CUDA context.
"""

from __future__ import annotations

from .aggregate import FleetSLO, fleet_fold, namespace_gauges
from .identity import ProcessIdentity, new_identity
from .publisher import SpoolPublisher, publisher_for_job

__all__ = [
    "FleetSLO", "ProcessIdentity", "SpoolPublisher", "fleet_fold",
    "namespace_gauges", "new_identity", "publisher_for_job",
]
