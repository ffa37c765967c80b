"""Managed model cache: device-memory-budget-aware residency for thousands of
registered tenants per device (README "Multi-tenant model multiplexing").

A real churn/fraud deployment owns per-segment models per tenant —
thousands of (model, version, variant) entries — but the eager serving
path (``serve.models``) holds every registered model's adapters
device-resident forever.  This module decouples *registered* from
*resident* the way INFaaS and TF-Serving do (PAPERS.md):

- **Catalog** — ``serve.cache.models`` registers models as COLD
  :class:`~avenir_tpu_torch.serve.registry.ModelDescriptor` s (artifact path +
  config fingerprint + variant presets; no artifact read, no device
  state).  Registration is O(config), so "thousands of tenants" costs
  kilobytes of host memory.
- **Resident set** — an LRU of fully-built replica sets (adapter +
  micro-batcher + breaker per replica, via the existing
  :class:`~avenir_tpu_torch.serve.pool.ScorerPool`), accounted in estimated
  device bytes (``ModelAdapter.device_bytes`` with a per-replica floor)
  against ``serve.cache.hbm.budget.bytes`` (falling back to the ingest
  pipeline's ``pipeline.device.budget.bytes``) and/or a
  ``serve.cache.max.resident`` count cap.  Promotion past the budget
  EVICTS least-recently-used tenants first: their batchers drain
  (queued requests complete), device tables release with the replicas,
  and the cold descriptor survives for a later re-promote.
- **Asynchronous promote** — a cache miss enqueues the build on
  ``serve.cache.promote.threads`` worker threads (build + warmup OFF
  the request path, the pre-swap pattern: nothing observable
  changes until a complete variant group installs).  The PREFERRED
  (cheapest) variant installs first — the model starts serving — and
  remaining variants follow; a request meanwhile routes to the resident
  variants (the router treats non-resident variants as demoted).  A
  promote failure (torn artifact, injected ``promote_fail``) leaves the
  previously-resident set serving untouched.
- **Cold start as a routable signal** — a request for a cataloged
  non-resident model either blocks up to
  ``serve.cache.coldstart.deadline.ms`` for the promote (then serves
  normally) or, with the deadline at 0 (or past it), gets a structured
  ``{"cold_start": true, "retry_after_ms": N}`` response whose retry
  hint is an EWMA of recent promote times bounded by
  ``serve.cache.retry.after.max.ms`` — clients retry on a schedule the
  server actually expects to meet.
- **Fairness** — every promote ENQUEUE is charged against the tenant's
  token bucket (serve/admission.py, ``serve.cache.tenant.quota.*``):
  one hot tenant thrashing cold<->resident cannot evict every sibling
  or starve the promote workers.

Compile reuse rides the process-shared
:class:`~avenir_tpu_torch.serve.engine.SharedCompileTier`: adapters key
compiled scorers by SHAPE SIGNATURE, so 1,000 same-schema NB tenants
share one compiled fold per bucket and steady-state ``Serve / Scorer
compilations`` stays flat across the fleet (asserted in
tests/test_modelcache.py).

Telemetry: ``serve.cache.resident`` / ``.resident.bytes`` /
``.registered`` / ``.evictions`` / ``.promote.queue.depth`` /
``.quota.rejected`` gauges plus the ``serve.cache.coldstart`` histogram
(request-arrival -> resident, with trace exemplars) flow through the
serve overlay into ``stats`` / ``health`` / the Prometheus exposition.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Set

from ..core import faultinject, flight, sanitizer
from ..core.metrics import Counters
from ..core.obs import LatencyHistogram, get_tracer
from ..core.pipeline import KEY_DEVICE_BUDGET
from .admission import QuotaExceeded, TenantAdmission
from .pool import ScorerPool
from .registry import KEY_CACHE_MODELS, ModelDescriptor, ModelRegistry

KEY_HBM_BUDGET = "serve.cache.hbm.budget.bytes"
KEY_MAX_RESIDENT = "serve.cache.max.resident"
KEY_COLDSTART_DEADLINE = "serve.cache.coldstart.deadline.ms"
KEY_RETRY_AFTER_MAX = "serve.cache.retry.after.max.ms"
KEY_PROMOTE_THREADS = "serve.cache.promote.threads"
KEY_PRELOAD = "serve.cache.preload"

DEFAULT_RETRY_AFTER_MAX_MS = 5000
DEFAULT_PROMOTE_THREADS = 1
#: per-replica residency floor: host-only adapters (device_bytes()==0)
#: still consume budget, so residency is never free
MIN_REPLICA_BYTES = 1 << 16

CACHE_GROUP = "Cache"


class ColdStartPending(RuntimeError):
    """A cataloged model is not resident: its promote is enqueued (or
    just failed) and the client should retry after ``retry_after_ms``.
    The server renders this as a structured ``cold_start`` response —
    never a hang, never a generic error."""

    def __init__(self, model: str, retry_after_ms: int,
                 detail: str = "promote enqueued"):
        super().__init__(
            f"model {model!r} is not resident (cold start: {detail}); "
            f"retry after {retry_after_ms}ms")
        self.model = model
        self.retry_after_ms = int(retry_after_ms)
        self.detail = detail


class _Promote:
    """One in-flight promote.  ``event`` fires as soon as the model is
    SERVABLE (first variant installed — what deadline-blocked requests
    wait on); ``done_event`` fires when every requested variant resolved
    (what the ops ``promote`` command waits on).  ``variants`` None =
    every declared variant."""

    __slots__ = ("name", "variants", "event", "done_event", "error",
                 "done", "enqueue_t", "trace_id", "retry_at")

    def __init__(self, name: str, variants: Optional[List[str]],
                 trace_id: Optional[str] = None):
        self.name = name
        self.variants = variants
        self.event = threading.Event()
        self.done_event = threading.Event()
        self.error: Optional[str] = None
        self.done = False
        self.enqueue_t = time.monotonic()
        self.trace_id = trace_id
        #: failure cooldown: a FAILED promote stays registered until
        #: this monotonic stamp, so client retries against a broken
        #: artifact join the cached failure instead of re-building it
        #: back-to-back (negative caching)
        self.retry_at = 0.0


class _Resident:
    """One resident model's accounting entry (LRU order lives in the
    cache's OrderedDict)."""

    __slots__ = ("name", "variant_bytes", "promoted_at")

    def __init__(self, name: str):
        self.name = name
        self.variant_bytes: Dict[str, int] = {}
        self.promoted_at = time.monotonic()

    @property
    def bytes(self) -> int:
        return sum(self.variant_bytes.values())

    @property
    def variants(self) -> Set[str]:
        return set(self.variant_bytes)


class ModelCache:
    """The managed cache over one registry + pool.  Thread-safe: I/O
    shard threads consult residency, promote workers mutate it, command
    threads demote — everything under one condition."""

    def __init__(self, config, registry: ModelRegistry, pool: ScorerPool,
                 admission: Optional[TenantAdmission] = None,
                 slo=None):
        self.config = config
        self.registry = registry
        self.pool = pool
        self.admission = admission
        self.slo = slo
        self.budget_bytes = config.get_int(KEY_HBM_BUDGET, 0) \
            or config.get_int(KEY_DEVICE_BUDGET, 0)
        self.max_resident = config.get_int(KEY_MAX_RESIDENT, 0)
        self.coldstart_deadline_ms = config.get_float(
            KEY_COLDSTART_DEADLINE, 0.0)
        self.retry_after_max_ms = config.get_int(
            KEY_RETRY_AFTER_MAX, DEFAULT_RETRY_AFTER_MAX_MS)
        # catalog: thousands of cold descriptors, validated up front
        # (unknown kind / missing kind fails at startup, not first use);
        # one shared conf-parse memo across the whole registration
        eager = set(registry.model_names())
        cached = registry.cached_model_names()
        for name in cached:
            if name in eager:
                raise ValueError(
                    f"model {name!r} is in both serve.models (eager, "
                    f"always resident) and serve.cache.models (managed "
                    f"residency) — pick one")
        self.catalog: Dict[str, ModelDescriptor] = \
            registry.describe_all(cached)
        self._cv = sanitizer.make_condition("serve.cache")
        self._resident: "OrderedDict[str, _Resident]" = OrderedDict()
        #: (model, variant) -> bytes RESERVED by an in-flight promote
        #: between its budget check and its accounting: with several
        #: promote workers, two concurrent installs must both see each
        #: other's claim or they would jointly overshoot the budget
        self._reserved: Dict[tuple, int] = {}
        self._promotes: Dict[str, _Promote] = {}
        self._queue: deque = deque()
        self._closed = False
        self._ewma_promote_s: Optional[float] = None
        self.counters = Counters()
        #: request-arrival -> resident latency (seconds), with trace
        #: exemplars — the ``serve.cache.coldstart`` histogram
        self.coldstart_hist = LatencyHistogram()
        # validate preload BEFORE the workers start: a bad name must
        # fail construction without leaking parked promote threads
        preload_names = [n.strip() for n in
                         (config.get(KEY_PRELOAD) or "").split(",")
                         if n.strip()]
        for name in preload_names:
            if name not in self.catalog:
                raise KeyError(
                    f"serve.cache.preload names {name!r} which is "
                    f"not in serve.cache.models")
        n_workers = max(1, config.get_int(KEY_PROMOTE_THREADS,
                                          DEFAULT_PROMOTE_THREADS))
        self._workers = [
            threading.Thread(target=self._worker,
                             name=f"modelcache-promote-{i}", daemon=True)
            for i in range(n_workers)]
        for t in self._workers:
            t.start()
        for name in preload_names:
            self.request_promote(name, charge=False)

    # -- catalog / residency lookups ---------------------------------------
    def is_cataloged(self, name) -> bool:
        return name in self.catalog

    def declared_variants(self, name) -> Optional[List[str]]:
        """The cataloged model's declared variant order (cheapest first),
        or None when the model is not managed by this cache — the
        router's view of variants that EXIST even while non-resident."""
        desc = self.catalog.get(name)
        return list(desc.variants) if desc is not None else None

    def resident_names(self) -> List[str]:
        with self._cv:
            return list(self._resident)

    def is_resident(self, name: str) -> bool:
        with self._cv:
            return name in self._resident

    def resident_bytes(self) -> int:
        with self._cv:
            return sum(r.bytes for r in self._resident.values())

    def needs_wait(self, name) -> bool:
        """True when a request for ``name`` would BLOCK on a cold-start
        promote (the event-loop frontend moves such requests off the I/O
        shard threads onto the cold-wait executor).  Total for ANY wire
        value: this runs on an I/O shard before request validation, so a
        garbage ``"model"`` (a list, a dict) must answer False — never
        raise — and let the validation path return the structured
        error."""
        if (self.coldstart_deadline_ms <= 0 or not isinstance(name, str)
                or name not in self.catalog):
            return False
        with self._cv:
            return name not in self._resident

    # -- the request path --------------------------------------------------
    def ensure(self, name: str, ctx=None, allow_wait: bool = True) -> None:
        """Called per request BEFORE routing: a no-op for non-cataloged
        models; bumps LRU recency for resident ones; for cold ones,
        enqueues the promote (charging the tenant's quota) and either
        blocks up to ``serve.cache.coldstart.deadline.ms`` for residency
        or raises :class:`ColdStartPending` /
        :class:`~avenir_tpu_torch.serve.admission.QuotaExceeded` for the
        server to render as a structured response.  ``allow_wait=False``
        never blocks regardless of the deadline — the event-loop
        frontend's inline path uses it so a model evicted between its
        residency pre-check and this call cannot stall an I/O shard
        (the client just gets the structured cold-start retry)."""
        if name not in self.catalog:
            return
        with self._cv:
            if name in self._resident:
                self._resident.move_to_end(name)
                return
        p = self.request_promote(name, ctx=ctx)
        deadline_s = (self.coldstart_deadline_ms / 1000.0
                      if allow_wait else 0.0)
        if deadline_s > 0 and p.event.wait(deadline_s):
            if p.error is None:
                with self._cv:
                    if name in self._resident:
                        self._resident.move_to_end(name)
                        return
                # the promote succeeded but a concurrent promote evicted
                # the model before this waiter's residency check
                raise ColdStartPending(name, self.retry_after_ms(),
                                       "evicted before the request "
                                       "could be served")
            raise ColdStartPending(name, self.retry_after_ms(),
                                   f"promote failed: {p.error}")
        detail = (f"promote failed: {p.error}"
                  if p.done and p.error is not None else "promoting")
        raise ColdStartPending(name, self.retry_after_ms(), detail)

    def request_promote(self, name: str, ctx=None,
                        variant: Optional[str] = None,
                        charge: bool = True,
                        force: bool = False) -> _Promote:
        """Enqueue (or join) the model's in-flight promote.  A NEW
        enqueue is charged against the tenant's token bucket (the
        fairness gate); joining an in-flight promote is free — a storm
        of requests for one cold tenant costs one token, one build.  A
        FAILED promote is negatively cached for a cooldown (its
        ``retry_at``): retries inside it join the cached failure
        instead of hammering the promote workers with back-to-back
        rebuilds of a broken artifact (``force`` — the operator
        ``promote`` command — bypasses the cooldown)."""
        if name not in self.catalog:
            raise KeyError(f"model {name!r} is not registered to the "
                           f"model cache (serve.cache.models)")
        trace_id = (ctx.trace_id
                    if ctx is not None and getattr(ctx, "sampled", False)
                    else None)
        with self._cv:
            if self._closed:
                raise RuntimeError("model cache is closed")
            p = self._promotes.get(name)
            if p is not None and p.done:
                # a negatively-cached failure: serve it until the
                # cooldown lapses (or an operator forces a rebuild)
                if not force and time.monotonic() < p.retry_at:
                    return p
                del self._promotes[name]
                p = None
            if p is not None:
                if variant is None:
                    # a FULL promote joining a variant-limited one must
                    # widen it, or the join would silently narrow the
                    # model to that single variant (the worker re-reads
                    # p.variants each build round, so this takes effect
                    # mid-promote)
                    p.variants = None
                elif (p.variants is not None
                        and variant not in p.variants):
                    p.variants.append(variant)
                return p
            if charge and self.admission is not None:
                try:
                    self.admission.charge(name)
                except QuotaExceeded:
                    self.counters.incr(CACHE_GROUP, "Quota rejected")
                    raise
            p = _Promote(name, [variant] if variant is not None else None,
                         trace_id=trace_id)
            self._promotes[name] = p
            self._queue.append(p)
            self.counters.incr(CACHE_GROUP, "Cold starts")
            self._cv.notify_all()
            return p

    def retry_after_ms(self) -> int:
        """Bounded retry hint: EWMA of recent promote wall times (250 ms
        before any promote completed), clamped to
        [50, ``serve.cache.retry.after.max.ms``]."""
        with self._cv:
            base_s = self._ewma_promote_s
        ms = int((base_s if base_s is not None else 0.25) * 1000.0)
        return max(50, min(ms, self.retry_after_max_ms))

    # -- ops surface (promote/demote commands, tests, runbook) -------------
    def promote(self, name: str, wait: bool = True,
                timeout_s: Optional[float] = None) -> bool:
        """Operator promote (not quota-charged); with ``wait`` blocks
        until the promote resolves and returns residency."""
        p = self.request_promote(name, charge=False, force=True)
        if wait:
            p.done_event.wait(timeout_s if timeout_s is not None else 60.0)
        with self._cv:
            return name in self._resident

    def demote(self, name: str, variant: Optional[str] = None) -> bool:
        """Drop a model (or one variant group) from the resident set:
        batchers drain, device state releases, the catalog descriptor
        survives, and the model's quarantine/SLO state is forgotten with
        it (a re-promote starts clean)."""
        if name not in self.catalog:
            raise KeyError(f"model {name!r} is not registered to the "
                           f"model cache (serve.cache.models)")
        if variant is None:
            with self._cv:
                self._resident.pop(name, None)
            ok = self.pool.unload_model(name)
            if self.slo is not None:
                self.slo.drop_model(name)
            if ok:
                self.counters.incr(CACHE_GROUP, "Demotes")
            return ok
        ok = self.pool.unload_variant(name, variant)
        if ok:
            with self._cv:
                rm = self._resident.get(name)
                if rm is not None:
                    rm.variant_bytes.pop(variant, None)
                    if not rm.variant_bytes:
                        del self._resident[name]
            self.counters.incr(CACHE_GROUP, "Demotes")
        return ok

    def nudge_promote(self, name: str, variant: Optional[str] = None,
                      ctx=None) -> None:
        """Background self-healing promote (the router's demoted-variant
        path): enqueue without waiting.  NOT quota-charged — this fires
        on a RESIDENT tenant's ordinary request path, and admission.py
        guarantees resident traffic never consumes promote tokens (a
        tenant whose missing variant keeps failing must not drain its
        bucket ahead of a genuine cold start)."""
        try:
            self.request_promote(name, ctx=ctx, variant=variant,
                                 charge=False)
        except (RuntimeError, KeyError):
            return

    def variant_cold(self, name: str, variant: str, ctx=None):
        """A request PINNED a declared-but-non-resident variant: enqueue
        its promote and return the ColdStartPending for the server to
        render (raising is the caller's choice)."""
        p = self.request_promote(name, ctx=ctx, variant=variant)
        detail = (f"variant {variant!r} promote failed: {p.error}"
                  if p.done and p.error is not None
                  else f"variant {variant!r} promoting")
        return ColdStartPending(name, self.retry_after_ms(), detail)

    # -- promote workers ---------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return            # closed and drained
                p = self._queue.popleft()
            self._do_promote(p)

    def _group_bytes(self, group) -> int:
        return sum(max(int(r.entry.adapter.device_bytes()),
                       MIN_REPLICA_BYTES) for r in group.replicas)

    def _do_promote(self, p: _Promote) -> None:
        name = p.name
        desc = self.catalog[name]
        err: Optional[str] = None
        tracer = get_tracer()
        try:
            fi = faultinject.get_injector()
            if fi is not None:
                fi.fire("promote_slow", tag=name)
                fi.fire("promote_fail", tag=name)
            while True:
                # recompute the worklist each round: a request pinning
                # another variant may JOIN this promote mid-build
                # (request_promote appends to p.variants) and must
                # still get its variant built
                with self._cv:
                    want = (list(p.variants) if p.variants is not None
                            else list(desc.variants))
                    rm = self._resident.get(name)
                    v = next((w for w in want
                              if rm is None or w not in rm.variant_bytes),
                             None)
                if v is None:
                    break
                with tracer.span("serve.cache.promote", model=name,
                                 variant=v):
                    group = self.pool.build_variant_group(name, v)
                gbytes = self._group_bytes(group)
                with self._cv:
                    # reserve BEFORE the budget check so a concurrent
                    # worker's check sees this claim (no joint overshoot)
                    self._reserved[(name, v)] = gbytes
                try:
                    self._evict_for(name)
                    try:
                        self.pool.install_group(name, group)
                    except BaseException:
                        for rep in group.replicas:
                            rep.batcher.close(drain=False)
                        raise
                    with self._cv:
                        rm = self._resident.get(name)
                        if rm is None:
                            rm = self._resident[name] = _Resident(name)
                        rm.variant_bytes[v] = gbytes
                        # reservation retires in the SAME critical
                        # section that accounts the bytes — a window
                        # between them would double-count and make a
                        # concurrent worker evict a tenant that fits
                        self._reserved.pop((name, v), None)
                        self._resident.move_to_end(name)
                        # the FIRST installed variant makes the model
                        # servable: wake deadline-blocked requesters now,
                        # remaining variants keep building in background
                        p.event.set()
                finally:
                    with self._cv:
                        self._reserved.pop((name, v), None)
        except Exception as e:              # noqa: BLE001
            # build_variant_group already closed its partial builds;
            # variants installed BEFORE the failure keep serving, and a
            # first-variant failure leaves the old resident set (and
            # everything else) untouched
            err = f"{type(e).__name__}: {e}"
        dt = time.monotonic() - p.enqueue_t
        with self._cv:
            p.error = err
            p.done = True
            if err is None:
                self._promotes.pop(name, None)
                self._ewma_promote_s = (
                    dt if self._ewma_promote_s is None
                    else 0.3 * dt + 0.7 * self._ewma_promote_s)
            else:
                # negative cache: the failed promote STAYS registered
                # for a bounded cooldown so client retries against a
                # broken artifact join the cached failure instead of
                # re-building it back-to-back (request_promote evicts
                # it once the cooldown lapses; operator `promote`
                # forces through)
                base_ms = int((self._ewma_promote_s
                               if self._ewma_promote_s is not None
                               else 0.25) * 1000.0)
                cooldown_ms = max(250, min(base_ms,
                                           self.retry_after_max_ms))
                p.retry_at = time.monotonic() + cooldown_ms / 1000.0
            self._cv.notify_all()
        if err is None:
            self.counters.incr(CACHE_GROUP, "Promotes")
            self.coldstart_hist.record(dt, trace_id=p.trace_id)
        else:
            self.counters.incr(CACHE_GROUP, "Promote failures")
            flight.trigger("promote_failure", model=name,
                           trace_id=p.trace_id, error=err)
        p.event.set()
        p.done_event.set()

    def _over_budget(self, protect: str) -> bool:
        """Budget check over resident + RESERVED state (the in-flight
        promote's own reservation is already in ``_reserved``, so its
        footprint counts).  The count cap gates NEW model names only:
        another variant of an already-resident/reserved model must not
        evict a sibling on count grounds (bytes still apply)."""
        names = set(self._resident)
        names.update(n for n, _v in self._reserved)
        if self.max_resident > 0 and len(names) > self.max_resident:
            return True
        if self.budget_bytes > 0:
            held = (sum(r.bytes for r in self._resident.values())
                    + sum(self._reserved.values()))
            return held > self.budget_bytes
        return False

    def _evict_for(self, protect: str) -> None:
        """Evict least-recently-used residents until the reserved bytes
        fit (``protect`` — the model being promoted — is never a
        victim; a model larger than the whole budget still promotes
        alone once everything else is out)."""
        while True:
            with self._cv:
                victim = None
                if self._over_budget(protect):
                    for n in self._resident:
                        if n != protect:
                            victim = n
                            break
                if victim is None:
                    return
                self._resident.pop(victim)
            self.pool.unload_model(victim)
            if self.slo is not None:
                self.slo.drop_model(victim)
            self.counters.incr(CACHE_GROUP, "Evictions")

    # -- lifecycle / reporting ---------------------------------------------
    def close(self) -> None:
        """Stop the promote workers; queued promotes fail fast (their
        waiters get a structured shutdown error, never a hang)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            for p in pending:
                self._promotes.pop(p.name, None)
                p.error = "server shutting down"
                p.done = True
                p.event.set()
                p.done_event.set()
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout=30)

    def section(self) -> dict:
        """The ``cache`` dict in stats/health (and the source of the
        serve.cache.* telemetry gauges)."""
        with self._cv:
            resident = list(self._resident)
            held = sum(r.bytes for r in self._resident.values())
            queued = sum(1 for p in self._promotes.values() if not p.done)
        c = self.counters.as_dict().get(CACHE_GROUP, {})
        out = {
            "registered": len(self.catalog),
            "resident": len(resident),
            "resident_models": resident,
            "resident_bytes": held,
            "budget_bytes": self.budget_bytes or None,
            "max_resident": self.max_resident or None,
            "promote_queue_depth": queued,
            "coldstart_deadline_ms": self.coldstart_deadline_ms or None,
            "retry_after_ms": self.retry_after_ms(),
            "coldstart_ms": self.coldstart_hist.percentiles_ms(),
            "counters": dict(c),
            "compile_tier": (self.registry.compile_tier.stats()
                             if self.registry.compile_tier is not None
                             else None),
        }
        if self.admission is not None:
            out["quota"] = self.admission.section()
        return out
