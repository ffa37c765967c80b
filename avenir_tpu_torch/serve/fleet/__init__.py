"""Pod-scale serving: the cross-process router tier.

N serving processes behind one torch-free dispatch process speaking the
same JSON-lines wire protocol — least-loaded per-model dispatch fed by
live in-flight counts and the fleetobs spool feeds' per-backend rolling
SLO views, retry-on-sibling failover for idempotent scoring requests,
and rate-limited hysteretic replica autoscaling + tenant residency
coordination over the backends' ``scale``/``promote`` verbs.

- ``backend``  — persistent pooled pipelined connections per backend,
  with fail-fast orphan callbacks when a backend dies mid-request.
- ``watch``    — spool-feed consumption as a library: per-backend SLO
  boards, staleness, residency, replica-count, and breaker/quarantine
  (``resilience`` section) views.
- ``control``  — the autoscale + residency coordination loops
  (leader-only) and the fleet quarantine-propagation pump.
- ``lease``    — file-atomic lease electing the ONE control leader
  among N replicated routers sharing a spool.
- ``router``   — the dispatch surface + ``python -m avenir_tpu_torch router``.
"""

from .backend import BackendLink, parse_backends        # noqa: F401
from .control import ControlLoop                        # noqa: F401
from .lease import RouterLease                          # noqa: F401
from .router import FleetRouter, router_main            # noqa: F401
from .watch import FeedWatch                            # noqa: F401

__all__ = ["BackendLink", "ControlLoop", "FeedWatch", "FleetRouter",
           "RouterLease", "parse_backends", "router_main"]
