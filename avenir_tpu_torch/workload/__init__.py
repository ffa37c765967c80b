"""Production-shaped workload harness (``python -m avenir_tpu_torch workload``).

A seeded, replayable scenario factory plus an SLO-envelope verdict
engine — the serving-side descendant of avenir's synthetic-data
generators.  Scenarios are properties manifests (``workload.*``)
declaring phased arrival processes, Zipf tenant popularity, payload
mixes, and chaos dials; the open-loop client fleet drives them against
the real ``serve`` frontend or ``stream`` consumer, and the run is
judged against the envelope the scenario declares.  See the README
"Workload harness" section and ``resource/workload/`` for the canned
scenarios (``flash_crowd``, ``zipf_tenant_storm``, ``poison_storm``,
``feedback_chaos``, ``workload_smoke``).
"""

from .driver import Fleet, LineClient, PhaseStats, classify     # noqa: F401
from .generators import (Event, ZipfSampler, arrival_offsets,   # noqa: F401
                         hot_share, partition, payload_rows,
                         schedule_bytes, zipf_weights)
from .runner import run_scenario, workload_main                 # noqa: F401
from .scenario import (Envelope, PhaseSpec, Scenario,           # noqa: F401
                       build_schedule, tenant_universe)
from .verdict import evaluate_phase, evaluate_run               # noqa: F401

__all__ = [
    "Event", "ZipfSampler", "arrival_offsets", "hot_share", "partition",
    "payload_rows", "schedule_bytes", "zipf_weights",
    "Envelope", "PhaseSpec", "Scenario", "build_schedule",
    "tenant_universe", "Fleet", "LineClient", "PhaseStats", "classify",
    "evaluate_phase", "evaluate_run", "run_scenario", "workload_main",
]
