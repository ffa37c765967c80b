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

# every name resolves on first use (PEP 562): the torch-free modules
# (frontend, slo, the fleet router) import without the adapters' torch
_EXPORTS = {
    "QuotaExceeded": "admission", "TenantAdmission": "admission",
    "MicroBatcher": "batcher", "ShedError": "batcher",
    "CircuitBreaker": "breaker", "CircuitOpenError": "breaker",
    "ADAPTER_KINDS": "engine", "SharedCompileTier": "engine",
    "get_shared_tier": "engine", "pow2_bucket": "engine",
    "EventLoopFrontend": "frontend",
    "ColdStartPending": "modelcache", "ModelCache": "modelcache",
    "ScorerPool": "pool", "ModelRegistry": "registry",
    "VariantRouter": "router",
    "PredictionServer": "server", "TruncatedResponseError": "server",
    "serve_main": "server", "SLOBoard": "slo",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = sorted(_EXPORTS)
