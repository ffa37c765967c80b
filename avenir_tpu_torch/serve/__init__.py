"""Online serving subsystem: model registry + dynamic micro-batching server.

The port's copy of ``avenir_tpu/serve``: load a trained artifact ONCE into
device-resident state (``cuda:0`` unless the caller asks for the CPU) and
answer prediction requests at low latency (the Clipper-style adaptive
micro-batching architecture; see PAPERS.md "Online serving").

- ``engine``   — per-model scorer adapters wrapping the ported predict
  paths (NB f32 log-space and f64 scorers; kNN on kernel K3; the Markov
  log-odds classifier; the decision tree's host routing; the streaming
  bandit decisions over the live posterior store) behind one
  ``predict_lines(lines) -> lines`` surface, with a build-counted bounded
  cache of scorers keyed on power-of-two batch buckets.
- ``registry`` — loads artifacts from their reference text formats,
  keyed by model name + version, with explicit warmup (each scorer built
  and run once at the configured buckets) and atomic hot-swap reload.
- ``batcher``  — the dynamic micro-batching queue: requests accumulate up
  to ``serve.batch.max.size`` or ``serve.batch.max.delay.ms``, score as one
  padded bucket, and scatter back to per-request futures; admission control
  (``serve.queue.max.depth``) sheds on overflow instead of OOMing.
- ``frontend`` — non-blocking ``selectors`` event-loop TCP frontend.
- ``pool``     — replica scorer pool: N batcher+scorer replicas per
  (model, variant), each on an explicit ``torch.device``, least-loaded
  dispatch by queue depth; hot-swap reload and the circuit breaker are
  per-replica.
- ``router``   — SLO-aware variant router (INFaaS-style).
- ``server``   — request routing + the ``python -m avenir_tpu_torch
  serve`` CLI entry, exporting per-model counters and latency quantiles.
- ``breaker``  — per-replica circuit breaker behind the
  graceful-degradation surface.
- ``modelcache`` + ``admission`` — multi-tenant model multiplexing:
  ``serve.cache.models`` registers tenants as COLD catalog descriptors
  behind a device-memory-budget-aware resident LRU.
"""

from .admission import QuotaExceeded, TenantAdmission           # noqa: F401
from .batcher import MicroBatcher, ShedError                    # noqa: F401
from .breaker import CircuitBreaker, CircuitOpenError           # noqa: F401
from .engine import (ADAPTER_KINDS, SharedCompileTier,          # noqa: F401
                     get_shared_tier, pow2_bucket)
from .frontend import EventLoopFrontend                         # noqa: F401
from .modelcache import ColdStartPending, ModelCache            # noqa: F401
from .pool import ScorerPool                                    # noqa: F401
from .registry import ModelRegistry                             # noqa: F401
from .router import VariantRouter                               # noqa: F401
from .server import (PredictionServer, TruncatedResponseError,  # noqa: F401
                     serve_main)
from .slo import SLOBoard                                       # noqa: F401

__all__ = ["ADAPTER_KINDS", "CircuitBreaker", "CircuitOpenError",
           "ColdStartPending", "EventLoopFrontend", "MicroBatcher",
           "ModelCache", "ModelRegistry", "PredictionServer",
           "QuotaExceeded", "SLOBoard", "ScorerPool",
           "SharedCompileTier", "ShedError", "TenantAdmission",
           "TruncatedResponseError", "VariantRouter", "get_shared_tier",
           "pow2_bucket", "serve_main"]
