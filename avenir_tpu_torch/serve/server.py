"""JSON-lines prediction frontend + the ``python -m avenir_tpu_torch serve`` CLI.

The port's copy of ``avenir_tpu/serve/server.py``: the same wire
protocol, config surface and stats, on PyTorch.  The server scores on
``cuda:0`` unless the caller asks for the CPU (``device=`` here,
``--device cpu`` on the command line), and fails when there is no card.

Wire protocol (one JSON object per line, one JSON response line each, in
request order per connection; concurrency comes from concurrent
connections — the ``selectors`` event-loop frontend multiplexes many
thousands of open sockets over a few I/O threads, and requests resolve
through batcher-future callbacks instead of parked handler threads):

    {"model": "churn", "row": "C001,planA,1210,505,8,11,3,Y"}
      -> {"model": "churn", "version": "1", "output": "C001,...,Y,87"}
    {"model": "churn", "rows": ["...", "..."]}          # client-side batch
      -> {"model": "churn", "version": "1", "outputs": ["...", "..."]}
    {"model": "churn", "row": "...", "slo_ms": 20}      # SLO-hinted routing
    {"model": "churn", "row": "...", "variant": "f64"}  # explicit variant pin
    {"cmd": "stats"}            -> per-model counters + latency percentiles
                                   + per-variant/per-replica pool state
    {"cmd": "health"}           -> {"ok": true, "models": [...], "slo": {...}}
    {"cmd": "metrics"}          -> Prometheus TEXT exposition (multi-line,
                                   terminated by "# EOF"; read it with
                                   ``request_text`` / a scrape loop)
    {"cmd": "reload", "model": "churn"}   -> hot swap from updated artifacts
        (+ optional "variant"/"replica" to swap one slice of the pool)

Error responses carry {"error": "..."} (plus {"shed": true} when admission
control rejected the request) and never tear down the connection.

Config surface (serve.properties): ``serve.host`` (default 127.0.0.1),
``serve.port`` (default 8650; 0 picks an ephemeral port, printed on
stderr), ``serve.batch.max.size``, ``serve.batch.max.delay.ms``,
``serve.queue.max.depth``, ``serve.request.timeout.sec``, plus the
registry's ``serve.models`` / ``serve.model.<name>.*`` surface (including
the ``serve.model.<name>.variants`` scorer-variant declarations) and
``serve.warmup`` (default true) — see registry.py.  Scale-out keys
(README "Online serving"): ``serve.pool.replicas`` (pool.py),
``serve.router.default.slo.ms`` / ``serve.router.strict`` (router.py),
``serve.frontend.threads`` / ``serve.frontend.backlog`` /
``serve.frontend.pipeline.max`` (frontend.py), and
``serve.drain.timeout.sec`` (graceful drain bound, this module).
Graceful-degradation keys (README "Fault tolerance"):
``serve.request.deadline.ms``, ``serve.breaker.failures`` /
``serve.breaker.reset.sec`` / ``serve.breaker.probe.requests``,
``serve.watchdog.interval.sec``, ``serve.max.line.bytes``.  Telemetry
keys (README "Telemetry & SLOs"): ``telemetry.interval.sec`` /
``telemetry.jsonl.path`` (or the ``--metrics-out`` flag) drive the
periodic exporter, and the ``serve.slo.*`` surface (slo.py) declares the
rolling-window targets whose violation flips the SLO gauges, the
``health`` report, the breaker's soft-degrade bit, and — through the
variant router — which scorer variant a request lands on.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from ..core import flight, obs, sanitizer, telemetry
from ..core.config import JobConfig, load_job_config, parse_cli_args
from .admission import QuotaExceeded, TenantAdmission
from .batcher import MicroBatcher, PoisonRowError, ShedError
from .breaker import CircuitOpenError
from .frontend import (DEFAULT_BACKLOG, DEFAULT_IO_THREADS,
                       DEFAULT_PIPELINE_MAX, EventLoopFrontend, KEY_BACKLOG,
                       KEY_IO_THREADS, KEY_PIPELINE_MAX)
from .modelcache import ColdStartPending, ModelCache
from .pool import ScorerPool, merged_hist_state
from .registry import KEY_CACHE_MODELS, ModelRegistry
from .router import SLOUnattainableError, VariantRouter
from .slo import SLOBoard

# a distinct class pre-3.11, an alias of the builtin after
from concurrent.futures import TimeoutError as _FutureTimeout

DEFAULT_MAX_LINE_BYTES = 1 << 20

KEY_DRAIN_TIMEOUT = "serve.drain.timeout.sec"
DEFAULT_DRAIN_TIMEOUT_SEC = 10.0

SERVE_GROUP = "Serve"


class TruncatedResponseError(RuntimeError):
    """A client helper read a response that ended (connection close or
    read deadline) before its framing terminator arrived; ``partial``
    carries whatever bytes did."""

    def __init__(self, message: str, partial: bytes = b""):
        super().__init__(message)
        self.partial = partial


class _Submission:
    """One predict request's routed submission state, shared by the
    synchronous (embedded/`handle_line`) and callback (event-loop
    frontend) completion paths."""

    __slots__ = ("entry", "decision", "multi_variant", "single", "futures",
                 "shed", "degraded", "last_err")

    def __init__(self, entry, decision, multi_variant, single, futures,
                 shed, degraded, last_err):
        self.entry = entry
        self.decision = decision
        self.multi_variant = multi_variant
        self.single = single
        self.futures = futures
        self.shed = shed
        self.degraded = degraded
        self.last_err = last_err


class PredictionServer:
    """In-process serving stack: registry + replica scorer pool +
    SLO-aware variant router + event-loop TCP frontend.  Usable embedded
    (tests, bench) or via ``serve_main``.

    Scale-out surface (pool.py / router.py / frontend.py): every
    (model, variant) owns ``serve.pool.replicas`` batcher+scorer
    replicas dispatched least-loaded; models declaring
    ``serve.model.<name>.variants`` (e.g. ``f32,f64``) are routed
    per-request by SLO hint with soft-degraded variants demoted to their
    siblings; the TCP frontend is a non-blocking ``selectors`` event
    loop, so 10k+ open sockets cost file descriptors, not threads.

    Graceful-degradation surface (see batcher.py / breaker.py):
    ``serve.request.deadline.ms`` (timeout responses instead of silent
    waits), ``serve.breaker.*`` (per-REPLICA circuit breaker —
    ``health`` reports ``degraded`` models), ``serve.watchdog.interval.sec``
    (a watchdog restarts any dead batcher worker), ``serve.max.line.bytes``
    (the frontend survives oversized or malformed request lines with a
    structured error response), and ``serve.drain.timeout.sec`` (shutdown
    completes or deadline-times-out every queued request — nothing is
    silently dropped)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.registry = ModelRegistry(config, device=device)
        self.timeout = config.get_float("serve.request.timeout.sec", 30.0)
        self.deadline_s = max(
            0.0, config.get_float("serve.request.deadline.ms", 0.0)) / 1000.0
        self.max_line_bytes = config.get_int("serve.max.line.bytes",
                                             DEFAULT_MAX_LINE_BYTES)
        self.drain_timeout_s = config.get_float(KEY_DRAIN_TIMEOUT,
                                                DEFAULT_DRAIN_TIMEOUT_SEC)
        batch_kw = dict(
            max_batch=config.get_int("serve.batch.max.size", 64),
            max_delay_ms=config.get_float("serve.batch.max.delay.ms", 2.0),
            max_queue_depth=config.get_int("serve.queue.max.depth", 256),
            hist_buckets=obs.histogram_buckets_from_config(config),
            deadline_ms=config.get_float("serve.request.deadline.ms", 0.0))
        self._lock = sanitizer.make_lock("serve.server")
        self._frontend: Optional[EventLoopFrontend] = None
        self._stopped = False
        self._stop_watchdog = threading.Event()
        # in-flight async collectors, reaped past their deadline by the
        # serve-timeout thread (started with the TCP frontend)
        self._inflight: set = set()
        self._inflight_lock = sanitizer.make_lock("serve.server.inflight")
        self._reaper_thread: Optional[threading.Thread] = None
        # the replica pool builds every (model, variant) group — one
        # adapter + batcher + breaker per replica — and adopts each
        # model's primary entry into the registry's legacy surface
        self.pool = ScorerPool(config, self.registry, batch_kw,
                               warmup=config.get_boolean("serve.warmup",
                                                         True))
        # telemetry: rolling SLO monitors (per variant group) + the
        # periodic exporter whose snapshot backs the ``metrics`` command
        # (Prometheus exposition) and the telemetry.jsonl.path series
        self.slo = SLOBoard(config)
        # managed model cache (serve/modelcache.py): serve.cache.models
        # registers thousands of tenants as COLD descriptors behind an
        # HBM-budget-aware resident LRU with per-tenant promote quotas
        try:
            self.admission = TenantAdmission.from_config(config)
            self.cache: Optional[ModelCache] = None
            if self.registry.cached_model_names():
                self.cache = ModelCache(config, self.registry, self.pool,
                                        admission=self.admission,
                                        slo=self.slo)
        except BaseException:
            # a bad cache/quota config must not leak the pool's already
            # started batcher workers (the no-leak hammer catches this)
            self.pool.close()
            raise
        self.router = VariantRouter(config, self.pool, self.slo,
                                    cache=self.cache)
        # commands can block (a reload rebuilds adapters; health
        # evaluates SLO windows) — they run here, never on an I/O shard
        self._cmd_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="serve-cmd")
        # deadline-blocked cold-start requests park on their OWN small
        # executor: a burst of cold tenants must not occupy the command
        # workers and black out health/metrics for the deadline window
        self._cold_pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=4,
                               thread_name_prefix="serve-coldwait")
            if self.cache is not None else None)
        #: subsystem command hooks: cmd name -> fn(request obj) -> response
        #: dict (the stream service registers "feedback"/"stream" here)
        self.command_extensions: Dict[str, Callable[[dict], dict]] = {}
        self._watchdog_thread = self._start_watchdog(
            config.get_float("serve.watchdog.interval.sec", 0.5))
        telemetry.configure_from_config(config)
        flight.configure_from_config(config)
        self.telemetry = telemetry.TelemetryExporter(
            config.get_float(telemetry.KEY_INTERVAL,
                             telemetry.DEFAULT_INTERVAL_SEC),
            jsonl_path=config.get(telemetry.KEY_JSONL_PATH),
            providers=[self._telemetry_overlay,
                       self._flight_snapshot_provider]).start()

    @staticmethod
    def _flight_snapshot_provider() -> None:
        """Rides the telemetry exporter's tick: the flight recorder's
        ring gets its periodic metrics snapshot even when no errors are
        flowing (the 'what did the system look like BEFORE' half of an
        anomaly dump)."""
        flight.get_recorder().maybe_snapshot()
        return None

    # -- watchdog ----------------------------------------------------------
    def _start_watchdog(self, interval_s: float) -> Optional[threading.Thread]:
        """A daemon thread that restarts any dead batcher worker (across
        every replica of every variant) every ``interval_s`` (0 disables
        — the defensive restart in ``submit`` still applies)."""
        if interval_s <= 0:
            return None

        def watch():
            while not self._stop_watchdog.wait(interval_s):
                self.pool.ensure_workers()

        t = threading.Thread(target=watch, name="serve-watchdog",
                             daemon=True)
        t.start()
        return t

    def batcher(self, name: str) -> MicroBatcher:
        """The model's primary batcher (preferred variant, replica 0) —
        the legacy single-batcher surface tests and the bench drive."""
        return self.pool.primary_batcher(name)

    # -- telemetry ---------------------------------------------------------
    def _observe_slo(self) -> Dict[str, dict]:
        """Evaluate every variant group's rolling SLO window NOW (also
        feeds the sustained-violation soft-degrade signal back into the
        group — the bit the router reads to demote it).  Keys are the
        groups' SLO keys: the bare model name for the implicit single
        default variant, ``model@variant`` otherwise."""
        out: Dict[str, dict] = {}
        for name in self.pool.model_names():
            for g in self._groups_or_gone(name):
                out[g.slo_key] = self.slo.observe(
                    g.slo_key, g.stats_facade, config_name=name)
        return out

    def _groups_or_gone(self, name: str) -> List:
        """The model's variant groups, or [] when a concurrent cache
        demote unloaded it between the name listing and this read (the
        reporting loops must tolerate models leaving mid-iteration)."""
        try:
            return self.pool.variant_groups(name)
        except KeyError:
            return []

    def _model_view(self, name: str):
        """(registry entry, variant groups) for a reporting loop, or
        None when a concurrent cache demote removed the model between
        the name listing and either read — the ONE place the
        demote-vs-reporting race is tolerated."""
        groups = self._groups_or_gone(name)
        if not groups:
            return None
        try:
            return self.registry.get(name), groups
        except KeyError:
            return None

    def _telemetry_overlay(self) -> dict:
        """The per-model snapshot sections the exporter/`metrics` scrape
        adds on top of the global registry: model-level latency
        histogram states, queue/breaker/worker gauges (breaker state as
        the 0/1/2 encoding), per-model counters, the SLO gauges, and the
        pool's per-variant (``serve.variant.*``) and per-replica
        (``serve.replica.*``) state plus router decision counts
        (``serve.router.*``)."""
        slo_stats = self._observe_slo()
        now = time.time()
        gauges: Dict[str, dict] = {}
        hists: Dict[str, dict] = {}
        counters: Dict[str, dict] = {}
        # the mergeable `resilience` section (core/telemetry.py): worst
        # breaker state code per model + quarantined poison signatures —
        # what sibling routers fold fleet-wide (pre-demote, propagation)
        res_breakers: Dict[str, int] = {}
        res_quarantine: Dict[str, dict] = {}

        def g(name, value, **labels):
            gauges[telemetry.labeled(name, **labels)] = {
                "value": float(value), "ts": now}

        for name in sorted(self.pool.model_names()):
            groups = self._groups_or_gone(name)
            if not groups:
                continue
            all_replicas = [r for grp in groups for r in grp.replicas]
            # model-level surface: byte-compatible with the pre-pool
            # single-batcher names (exactly one sample per model)
            hists[telemetry.labeled("serve.e2e.latency", model=name)] = \
                merged_hist_state([r.batcher.e2e_hist
                                   for r in all_replicas])
            hists[telemetry.labeled("serve.queue.wait", model=name)] = \
                merged_hist_state([r.batcher.queue_wait_hist
                                   for r in all_replicas])
            g("serve.queue.depth", sum(r.depth() for r in all_replicas),
              model=name)
            g("serve.worker.alive",
              1 if all(r.batcher.worker_alive() for r in all_replicas)
              else 0, model=name)
            primary_brk = groups[0].replicas[0].batcher.breaker
            g("serve.breaker.state", primary_brk.state_code()
              if primary_brk is not None else 0, model=name)
            g("serve.breaker.soft.degraded",
              1 if any(grp.soft_degraded for grp in groups) else 0,
              model=name)
            counters[f"Serve.{name}"] = self.pool.merged_counters(
                name).get(SERVE_GROUP, {})
            stats = slo_stats.get(groups[0].slo_key) or {}
            if stats.get("p50_ms") is not None:
                g("serve.slo.p50.ms", stats["p50_ms"], model=name)
            if stats.get("p99_ms") is not None:
                g("serve.slo.p99.ms", stats["p99_ms"], model=name)
            g("serve.slo.shed.pct", stats.get("shed_pct", 0.0), model=name)
            g("serve.slo.error.pct", stats.get("error_pct", 0.0),
              model=name)
            g("serve.slo.violation", 1 if stats.get("violation") else 0,
              model=name)
            g("serve.slo.sustained", 1 if stats.get("sustained") else 0,
              model=name)
            # per-variant + per-replica pool state
            for grp in groups:
                v = grp.variant
                g("serve.variant.queue.depth", grp.depth(),
                  model=name, variant=v)
                g("serve.variant.admitting", grp.admitting_replicas(),
                  model=name, variant=v)
                g("serve.variant.soft.degraded",
                  1 if grp.soft_degraded else 0, model=name, variant=v)
                g("serve.variant.healthy", 1 if grp.healthy() else 0,
                  model=name, variant=v)
                g("serve.router.routed", self.router.routed(name, v),
                  model=name, variant=v)
                vstats = slo_stats.get(grp.slo_key) or {}
                if vstats.get("p99_ms") is not None:
                    g("serve.variant.slo.p99.ms", vstats["p99_ms"],
                      model=name, variant=v)
                for r in grp.replicas:
                    brk = r.batcher.breaker
                    g("serve.replica.queue.depth", r.depth(),
                      model=name, variant=v, replica=r.index)
                    g("serve.replica.breaker.state",
                      brk.state_code() if brk is not None else 0,
                      model=name, variant=v, replica=r.index)
                    g("serve.replica.worker.alive",
                      1 if r.batcher.worker_alive() else 0,
                      model=name, variant=v, replica=r.index)
            g("serve.router.demotions", self.router.demotions(name),
              model=name)
            # poison-isolation state (serve.poison.*): cumulative poison
            # rows + the bounded quarantine cache's live size
            merged = counters[f"Serve.{name}"]
            g("serve.poison.rows", merged.get("Poison rows", 0),
              model=name)
            q = self.pool.quarantines.get(name)
            if q is not None:
                g("serve.poison.quarantine.size", q.size(), model=name)
                sigs = q.export()
                if sigs:
                    res_quarantine[name] = sigs
            res_breakers[name] = max(
                (r.batcher.breaker.state_code()
                 for r in all_replicas if r.batcher.breaker is not None),
                default=0)
        if self._frontend is not None:
            g("serve.frontend.connections", self._frontend.connections())
            # the fleet router binds spool feeds to its configured
            # backends by matching this gauge against host:port targets
            g("serve.frontend.port", self._frontend.port)
        if self.cache is not None:
            # managed-cache surface: residency/eviction/promote gauges +
            # the cold-start histogram (request-arrival -> resident, ms
            # percentiles via the shared log-bucket ladder, with trace
            # exemplars in the Prometheus exposition)
            sec = self.cache.section()
            g("serve.cache.registered", sec["registered"])
            g("serve.cache.resident", sec["resident"])
            g("serve.cache.resident.bytes", sec["resident_bytes"])
            g("serve.cache.promote.queue.depth",
              sec["promote_queue_depth"])
            cc = sec["counters"]
            g("serve.cache.evictions", cc.get("Evictions", 0))
            g("serve.cache.promotes", cc.get("Promotes", 0))
            g("serve.cache.promote.failures",
              cc.get("Promote failures", 0))
            g("serve.cache.quota.rejected", cc.get("Quota rejected", 0))
            tier = sec.get("compile_tier")
            if tier:
                g("serve.cache.compile.tier.size", tier["size"])
                g("serve.cache.compile.tier.compiles", tier["compiles"])
            hists["serve.cache.coldstart"] = \
                self.cache.coldstart_hist.state_dict()
            counters["Cache"] = dict(cc)
        out = {"gauges": gauges, "hists": hists, "counters": counters}
        if res_breakers or res_quarantine:
            out["resilience"] = {"breakers": res_breakers,
                                 "quarantine": res_quarantine}
        return out

    def metrics_text(self) -> str:
        """The Prometheus text exposition of the current combined
        snapshot (global registry + serve overlay) — what the ``metrics``
        command returns and a scrape loop parses."""
        return telemetry.prometheus_text(self.telemetry.snapshot())

    def _default_model(self) -> str:
        names = self.registry.model_names()
        if len(names) == 1:
            return names[0]
        raise KeyError(
            "request must name a model (\"model\": ...) when more than one "
            "is served")

    # -- request handling --------------------------------------------------
    @staticmethod
    def _begin_request(obj: dict):
        """Parse one request's identity: the client's ``request_id``
        (echoed verbatim on every response) and its
        :class:`~avenir_tpu_torch.core.obs.TraceContext` — client-supplied
        ``trace_id`` propagated (and force-sampled), else generated and
        head-sampled at ``obs.sample.rate``."""
        rid = obj.get("request_id")
        raw = obj.get("trace_id")
        ctx = obs.new_trace_context(
            raw if isinstance(raw, str) and raw else None)
        return rid, ctx

    def _finish_response(self, resp, rid, ctx, t0_ns: int,
                         conn=None):
        """The ONE response chokepoint: every response to a PARSED
        request — success, structured error, shed, deadline, drain
        timeout, poison — passes through here on both the sync
        (``handle_line``) and async (``dispatch_line`` callback) paths.
        It (a) echoes the client's ``request_id``, (b) echoes
        ``trace_id`` when the request is sampled — error/shed/poison
        responses are ALWAYS sampled retroactively (Dapper's
        never-drop-the-interesting-ones rule), (c) retroactively records
        the request's root ``serve.request`` span under its
        pre-allocated span id, and (d) feeds error responses to the
        flight recorder's wire-error ring.  The tier-2 lint
        (tests/test_obs_coverage.py) asserts every response-construction
        site in this module funnels here."""
        if not isinstance(resp, dict) or "_text" in resp:
            return resp         # raw-text exposition: no JSON identity
        if rid is not None:
            resp.setdefault("request_id", rid)
        if ctx is None:
            return resp
        errorish = ("error" in resp or bool(resp.get("shed"))
                    or bool(resp.get("poison"))
                    or bool(resp.get("timeout")))
        tracer = obs.get_tracer()
        if errorish and tracer.enabled and not ctx.sampled:
            ctx.sampled = True
        if errorish or ctx.sampled:
            resp.setdefault("trace_id", ctx.trace_id)
        if ctx.sampled and tracer.enabled:
            attrs = {"conn": conn} if conn is not None else {}
            if resp.get("model") is not None:
                attrs["model"] = resp["model"]
            if errorish:
                attrs["error"] = str(resp.get("error", ""))[:200]
            tracer.record_span(
                "serve.request", t0_ns,
                time.perf_counter_ns() - t0_ns,
                span_id=ctx.span_id, ctx=ctx, **attrs)
        if errorish:
            flight.record("wire.error", trace_id=ctx.trace_id,
                          model=resp.get("model"),
                          error=str(resp.get("error", ""))[:500],
                          shed=bool(resp.get("shed")),
                          poison=bool(resp.get("poison")),
                          timeout=bool(resp.get("timeout")))
        return resp

    def handle_line(self, line: str) -> dict:
        """Synchronous request path (embedded users, tests): parse,
        execute, and return the response dict, waiting on futures."""
        t0 = time.perf_counter_ns()
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            # pre-parse failure: no request_id/trace to echo (lint
            # exclusion — the identity was never readable)
            return {"error": f"bad request JSON: {e}"}
        if not isinstance(obj, dict):
            return {"error": "request must be a JSON object"}
        rid, ctx = self._begin_request(obj)
        return self._finish_response(self._handle_obj(obj, ctx),
                                     rid, ctx, t0)

    def _handle_obj(self, obj: dict, ctx=None) -> dict:
        cmd = obj.get("cmd")
        try:
            if cmd is not None:
                return self._command(cmd, obj)
            return self._predict(obj, ctx)
        except (KeyError, ValueError) as e:
            return {"error": str(e)}
        except Exception as e:                      # noqa: BLE001
            # a failed reload (missing artifact), a batcher racing a hot
            # swap, ... — the connection must survive every request error
            return {"error": f"{type(e).__name__}: {e}"}

    def _command(self, cmd: str, obj: dict) -> dict:
        if cmd == "stats":
            return self._stats()
        if cmd == "health":
            return self._health()
        if cmd == "metrics":
            # Prometheus text exposition, NOT a JSON line: the frontend
            # writes the raw text (terminated by "# EOF")
            return {"_text": self.metrics_text()}
        if cmd == "reload":
            model = obj.get("model") or self._default_model()
            entry = self.pool.reload(model, variant=obj.get("variant"),
                                     replica=obj.get("replica"))
            return {"ok": True, "model": entry.name,
                    "version": entry.version}
        if cmd == "promote":
            if self.cache is None:
                return {"error": "no model cache configured "
                                 "(serve.cache.models)"}
            model = obj.get("model")
            if not isinstance(model, str):
                return {"error": 'promote needs "model" (string)'}
            ok = self.cache.promote(model, wait=bool(obj.get("wait", True)))
            return {"ok": ok, "model": model, "resident": ok}
        if cmd == "scale":
            # the fleet router's autoscale verb: resize a model's replica
            # pools in place (pre-swap grow / draining-tail shrink).  A
            # scale racing the graceful drain window is REJECTED cleanly
            # (the pool is about to close; resizing it would race the
            # drain of in-flight requests), and a command carrying a
            # router-lease generation below the highest applied is
            # refused by the pool (stale-leader fence)
            if self._stopped:
                return {"error": "server draining: scale rejected",
                        "draining": True}
            model = obj.get("model") or self._default_model()
            try:
                n = int(obj.get("replicas"))
            except (TypeError, ValueError):
                return {"error": 'scale needs "replicas" (int >= 1)'}
            gen = obj.get("generation")
            if gen is not None:
                try:
                    gen = int(gen)
                except (TypeError, ValueError):
                    return {"error": 'scale "generation" must be an int'}
            out = self.pool.scale(model, n, variant=obj.get("variant"),
                                  generation=gen)
            out["ok"] = True
            if gen is not None:
                out["generation"] = gen
            return out
        if cmd == "quarantine":
            # fleet poison propagation (idempotent): seed signatures a
            # sibling backend already quarantined, so matching rows are
            # refused at submit BEFORE this process's first scorer
            # failure on them
            model = obj.get("model")
            if not isinstance(model, str):
                return {"error": 'quarantine needs "model" (string)'}
            sigs = obj.get("signatures")
            if not isinstance(sigs, dict) or not sigs:
                return {"error": 'quarantine needs "signatures" '
                                 '({signature: offenses})'}
            out = self.pool.seed_quarantine(model, sigs)
            out.update({"ok": True, "model": model})
            return out
        if cmd == "demote":
            if self.cache is None:
                return {"error": "no model cache configured "
                                 "(serve.cache.models)"}
            model = obj.get("model")
            if not isinstance(model, str):
                return {"error": 'demote needs "model" (string)'}
            ok = self.cache.demote(model, variant=obj.get("variant"))
            return {"ok": ok, "model": model, "resident": False}
        ext = self.command_extensions.get(cmd)
        if ext is not None:
            # subsystem-registered commands (e.g. the stream service's
            # "feedback"/"stream"): responses funnel through the same
            # _finish_response chokepoint as every built-in command
            return ext(obj)
        return {"error": f"unknown cmd {cmd!r}"}

    # -- predict: routing + submission (shared sync/async) -----------------
    def _submit(self, obj: dict, ctx=None, allow_wait: bool = True) -> object:
        """Validate, route, and submit one predict request's rows; returns
        a :class:`_Submission`, or a complete error-response dict for
        malformed requests.  ``ctx`` (the request's trace context) rides
        into the queue entries so the batcher worker can link its shared
        batch span back to this request.  ``allow_wait=False`` (the
        event-loop frontend's inline path) turns a cold-start block into
        an immediate structured response — an I/O shard thread must
        never park on a promote."""
        name = obj.get("model") or self._default_model()
        if self.cache is not None:
            try:
                # cold-start admission: resident models bump LRU recency
                # and fall through; cold cataloged models enqueue a
                # promote and either block here (up to the configured
                # cold-start deadline, on a cold-wait executor thread
                # for the async path) or surface the structured signal
                self.cache.ensure(name, ctx=ctx, allow_wait=allow_wait)
            except ColdStartPending as e:
                return {"model": name, "error": str(e),
                        "cold_start": True,
                        "retry_after_ms": e.retry_after_ms}
            except QuotaExceeded as e:
                return {"model": name, "error": str(e),
                        "quota_exceeded": True,
                        "retry_after_ms": e.retry_after_ms}
        # version validation against the registry's adopted surface
        try:
            entry = self.registry.get(name, obj.get("version"))
        except KeyError:
            resp = self._evicted_mid_request(name, ctx)
            if resp is None:
                raise
            return resp
        slo_ms = obj.get("slo_ms")
        if slo_ms is not None and not isinstance(slo_ms, (int, float)):
            return {"error": '"slo_ms" must be a number (milliseconds)'}
        pin = obj.get("variant")
        if pin is not None and not isinstance(pin, str):
            return {"error": '"variant" must be a string'}
        rows = obj.get("rows")
        single = rows is None
        if single:
            row = obj.get("row")
            if row is None:
                # streaming-decision alias: {"decide": "eventID,tenant"}
                # routes identically to {"row": ...} (avenir_tpu/stream)
                row = obj.get("decide")
            if not isinstance(row, str):
                return {"error": 'request needs "row" (string), "rows" '
                                 '(list of strings), or "decide" (string)'}
            rows = [row]
        elif (not isinstance(rows, list)
              or not all(isinstance(r, str) for r in rows)):
            # validate BEFORE submitting: one malformed entry must not
            # poison a shared micro-batch with other clients' requests
            return {"error": '"rows" must be a list of strings'}
        tracer = obs.get_tracer()
        traced = (ctx is not None and ctx.sampled and tracer.enabled)
        try:
            if traced:
                with tracer.span("serve.route", ctx=ctx, model=name):
                    group, decision = self.router.route(
                        name,
                        slo_ms=float(slo_ms) if slo_ms is not None
                        else None,
                        variant=pin)
            else:
                group, decision = self.router.route(
                    name,
                    slo_ms=float(slo_ms) if slo_ms is not None else None,
                    variant=pin)
        except SLOUnattainableError as e:
            return {"model": entry.name, "version": entry.version,
                    "error": str(e), "slo_unattainable": True}
        except ColdStartPending as e:
            # a pinned declared-but-non-resident variant: its promote is
            # enqueued, the client retries on the structured signal
            return {"model": entry.name, "version": entry.version,
                    "error": str(e), "cold_start": True,
                    "retry_after_ms": e.retry_after_ms}
        except QuotaExceeded as e:
            return {"model": entry.name, "version": entry.version,
                    "error": str(e), "quota_exceeded": True,
                    "retry_after_ms": e.retry_after_ms}
        except KeyError:
            # the routed model was demoted between the registry lookup
            # and routing: same structured signal as any cold start
            resp = self._evicted_mid_request(name, ctx)
            if resp is None:
                raise
            return resp
        # "multi-variant" responses carry the routed variant: judged by
        # the DECLARED variant count for cache-managed models (a model
        # temporarily down to one resident variant still reports which
        # variant — and that it was demoted)
        declared = (self.cache.declared_variants(name)
                    if self.cache is not None else None)
        multi = (len(declared) if declared is not None
                 else len(self.pool.variant_groups(name))) > 1
        futures: List[Optional[object]] = []
        shed, degraded = 0, 0
        last_err = "request failed"
        if single:
            try:
                futures.append(group.submit(rows[0], ctx=ctx))
            except ShedError:
                futures.append(None)
                shed += 1
            except (CircuitOpenError, RuntimeError) as e:
                # every replica of the routed group refused (breakers
                # open / batchers mid-swap): the model variant is
                # degraded, not the request
                futures.append(None)
                degraded += 1
                last_err = str(e)
        else:
            # client-side batch: one replica, one lock round (and the
            # whole batch coalesces into that replica's micro-batches)
            try:
                futures, shed = group.submit_many(rows, ctx=ctx)
            except ShedError:
                futures = [None] * len(rows)
                shed = len(rows)
            except (CircuitOpenError, RuntimeError) as e:
                futures = [None] * len(rows)
                degraded = len(rows)
                last_err = str(e)
        return _Submission(entry, decision, multi, single, futures,
                           shed, degraded, last_err)

    def _evicted_mid_request(self, name: str, ctx) -> Optional[dict]:
        """A cache-managed model can be EVICTED between this request's
        admission check and its registry/route lookups (a concurrent
        promote picked it as the LRU victim).  Clients honoring the
        documented signals must see the structured ``cold_start`` — a
        generic unknown-model error would read as 'stop retrying'.
        Returns the response dict, or None when the KeyError was not
        this race (unknown model/variant/version: let it propagate)."""
        if (self.cache is None or not self.cache.is_cataloged(name)
                or self.cache.is_resident(name)):
            return None
        try:
            self.cache.ensure(name, ctx=ctx, allow_wait=False)
        except ColdStartPending as e:
            return {"model": name, "error": str(e), "cold_start": True,
                    "retry_after_ms": e.retry_after_ms}
        except QuotaExceeded as e:
            return {"model": name, "error": str(e),
                    "quota_exceeded": True,
                    "retry_after_ms": e.retry_after_ms}
        # promoted again in the race window: tell the client to retry
        # now rather than re-entering the submit path recursively
        return {"model": name,
                "error": f"model {name!r} was evicted and re-promoted "
                         f"mid-request; retry",
                "cold_start": True,
                "retry_after_ms": 50}

    def _assemble(self, sub: _Submission, outputs: List[Optional[str]],
                  errors: int, timeouts: int, last_err: str,
                  poisons: int = 0) -> dict:
        resp: dict = {"model": sub.entry.name, "version": sub.entry.version}
        if sub.multi_variant or "pinned" in sub.decision:
            resp["variant"] = sub.decision["variant"]
            if sub.decision.get("demoted"):
                resp["demoted"] = True
            if "slo_met" in sub.decision:
                resp["slo_met"] = sub.decision["slo_met"]
        if sub.single:
            if sub.shed:
                resp["error"] = ("request shed: queue at "
                                 "serve.queue.max.depth")
                resp["shed"] = True
                return resp
            if sub.degraded:
                resp["error"] = last_err
                resp["degraded"] = True
                return resp
            if outputs[0] is None:
                resp["error"] = last_err
                if timeouts:
                    resp["timeout"] = True
                if poisons:
                    # this row individually failed the scorer (or is
                    # quarantined) — cohabiting requests were unaffected
                    resp["poison"] = True
                return resp
            resp["output"] = outputs[0]
            return resp
        resp["outputs"] = outputs
        if sub.shed:
            resp["shed"] = sub.shed
        if sub.degraded:
            resp["degraded"] = sub.degraded
        if timeouts:
            resp["timeouts"] = timeouts
        if errors:
            resp["errors"] = errors
        if poisons:
            resp["poison"] = poisons
        return resp

    def _predict(self, obj: dict, ctx=None) -> dict:
        """Synchronous predict: submit, then WAIT on the futures (the
        embedded/handle_line path; the event-loop frontend uses
        ``_predict_async`` instead, which never blocks a thread)."""
        sub = self._submit(obj, ctx)
        if isinstance(sub, dict):
            return sub
        t0 = time.perf_counter()
        # the client-side wait honors the request deadline when one is
        # configured (the queue-side half lives in the batcher worker),
        # bounded by the legacy serve.request.timeout.sec either way
        wait_s = (min(self.deadline_s, self.timeout) if self.deadline_s
                  else self.timeout)
        outputs, errors, timeouts, poisons = [], 0, 0, 0
        last_err = sub.last_err
        for f in sub.futures:
            if f is None:
                outputs.append(None)
                continue
            try:
                remaining = max(wait_s - (time.perf_counter() - t0), 0.001)
                outputs.append(f.result(timeout=remaining))
            except (TimeoutError, _FutureTimeout) as e:
                # queued past its deadline (worker-set TimeoutError) or
                # still scoring when the client-side wait expired: a
                # structured timeout response, never a silent wait
                outputs.append(None)
                errors += 1
                timeouts += 1
                last_err = str(e) or "request deadline exceeded"
            except Exception as e:                  # noqa: BLE001
                outputs.append(None)
                errors += 1
                if isinstance(e, PoisonRowError):
                    poisons += 1
                last_err = str(e)
        return self._assemble(sub, outputs, errors, timeouts, last_err,
                              poisons)

    # -- async dispatch (the event-loop frontend's entry) ------------------
    def dispatch_line(self, line: str, cb: Callable[[dict], None],
                      conn=None) -> Optional[dict]:
        """Non-blocking request dispatch: ``cb(response)`` fires exactly
        once, on whatever thread resolves the request — immediately for
        malformed requests, on a command-executor thread for commands,
        and from the batcher workers' future callbacks for predictions.
        NEVER blocks the calling (I/O shard) thread on a scorer.

        Returns the request's wire identity (``{"request_id": ...}``)
        synchronously so the frontend can stamp drain-timeout fillers
        for slots whose callback never fires; None when the line carried
        no request_id (or never parsed)."""
        t0 = time.perf_counter_ns()
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            # pre-parse failure: identity unreadable (lint exclusion)
            cb({"error": f"bad request JSON: {e}"})
            return None
        if not isinstance(obj, dict):
            cb({"error": "request must be a JSON object"})
            return None
        rid, ctx = self._begin_request(obj)
        inner = cb

        def cb(resp, _inner=inner, _rid=rid, _ctx=ctx, _t0=t0,
               _conn=conn):
            # the response chokepoint rides the callback: the request's
            # root serve.request span is recorded retroactively at
            # response time (no thread carries the request across the
            # async hop), identity echoed on every path
            _inner(self._finish_response(resp, _rid, _ctx, _t0,
                                         conn=_conn))

        meta = {"request_id": rid} if rid is not None else None
        if obj.get("cmd") is not None:
            try:
                self._cmd_pool.submit(
                    lambda: cb(self._handle_obj(obj, ctx)))
            except RuntimeError:                     # executor shut down
                cb({"error": "server shutting down"})
            return meta
        if (self._cold_pool is not None
                and self.cache.needs_wait(obj.get("model"))):
            # a cold-start request that would BLOCK up to the configured
            # cold-start deadline waiting for its promote: park it on
            # the cold-wait executor so it stalls neither an I/O shard
            # nor the command workers (health/metrics stay responsive
            # through a cold burst)
            try:
                self._cold_pool.submit(
                    lambda: cb(self._handle_obj(obj, ctx)))
            except RuntimeError:
                cb({"error": "server shutting down"})
            return meta
        try:
            # inline path: a model evicted between needs_wait and here
            # must yield the structured cold-start response, never park
            # this I/O shard on the promote
            sub = self._submit(obj, ctx, allow_wait=False)
        except (KeyError, ValueError) as e:
            cb({"error": str(e)})
            return meta
        except Exception as e:                      # noqa: BLE001
            cb({"error": f"{type(e).__name__}: {e}"})
            return meta
        if isinstance(sub, dict):
            cb(sub)
            return meta
        # the async path honors the same client-wait bound as the sync
        # one: a collector not finished by its deadline is force-timed
        # out by the reaper (a hung scorer whose worker thread is still
        # alive would otherwise hang the connection forever)
        wait_s = (min(self.deadline_s, self.timeout) if self.deadline_s
                  else self.timeout)
        coll = _AsyncCollector(self, sub, cb,
                               deadline=time.monotonic() + wait_s)
        with self._inflight_lock:
            self._inflight.add(coll)
        coll.arm()
        return meta

    def _reap_expired(self) -> None:
        """Time out every in-flight async request past its deadline
        (runs on the serve-timeout reaper thread)."""
        now = time.monotonic()
        with self._inflight_lock:
            due = [c for c in self._inflight if c.deadline <= now]
        for c in due:
            c.expire()

    def _start_reaper(self) -> threading.Thread:
        def reap():
            interval = max(0.05, min(1.0, self.timeout / 4.0))
            while not self._stop_watchdog.wait(interval):
                self._reap_expired()

        t = threading.Thread(target=reap, name="serve-timeout",
                             daemon=True)
        t.start()
        return t

    # -- reporting ---------------------------------------------------------
    def _health(self) -> dict:
        """Health reports DEGRADED models explicitly: a model with a
        non-closed primary breaker, any dead batcher worker, or any
        variant group in SUSTAINED SLO violation is still listed
        (requests keep flowing — demoted to sibling variants/replicas
        where possible — with the state visible) but the top-level
        ``ok`` drops to False so orchestrators can see it.  The ``slo``
        section carries every variant group's windowed stats under its
        SLO key (the bare model name for single-default-variant models,
        ``model@variant`` otherwise), and each model's ``variants``
        section carries per-replica queue/breaker/worker state."""
        slo_stats = self._observe_slo()
        models, degraded = [], []
        for name in sorted(self.pool.model_names()):
            view = self._model_view(name)
            if view is None:
                continue
            entry, groups = view
            primary_brk = groups[0].replicas[0].batcher.breaker
            state = primary_brk.state if primary_brk is not None else "closed"
            worker_ok = all(r.batcher.worker_alive()
                            for grp in groups for r in grp.replicas)
            slo_bad = any(bool((slo_stats.get(grp.slo_key) or {})
                               .get("sustained")) for grp in groups)
            breaker_bad = any(
                r.batcher.breaker is not None
                and r.batcher.breaker.state != "closed"
                for grp in groups for r in grp.replicas)
            if breaker_bad or not worker_ok or slo_bad:
                degraded.append(name)
            models.append({
                "name": name, "version": entry.version, "kind": entry.kind,
                "breaker": state, "slo_degraded": slo_bad,
                "worker_alive": worker_ok,
                "variants": {
                    grp.variant: grp.section(slo_stats.get(grp.slo_key))
                    for grp in groups},
                "router": self.router.section(name)})
        out = {"ok": not degraded, "degraded": degraded, "models": models,
               "slo": slo_stats}
        if self.cache is not None:
            out["cache"] = self.cache.section()
        return out

    def _stats(self) -> dict:
        models = {}
        for name in sorted(self.pool.model_names()):
            view = self._model_view(name)
            if view is None:
                continue
            entry, groups = view
            b = groups[0].replicas[0].batcher
            models[name] = {
                "version": entry.version,
                "kind": entry.kind,
                # merged across every replica of every variant (equals
                # the single batcher's counters in the default shape)
                "counters": self.pool.merged_counters(name),
                # byte-compatible p50/p95/p99 field names, sourced from
                # the PRIMARY replica's histogram (the legacy surface)
                "latency_ms": b.latency_percentiles_ms(),
                "histograms": b.histograms(),
                "batch_fill_ratio": (round(b.fill_ratio(), 4)
                                     if b.fill_ratio() is not None
                                     else None),
                "queue_depth": sum(grp.depth() for grp in groups),
                "breaker": (b.breaker.state_dict()
                            if b.breaker is not None else None),
                "variants": {grp.variant: grp.section() for grp in groups},
                "router": self.router.section(name),
            }
            q = self.pool.quarantines.get(name)
            if q is not None:
                models[name]["poison"] = {
                    "quarantine_size": q.size(),
                    "threshold": q.threshold}
        out = {"models": models, "obs": obs.get_tracer().stats(),
               "slo": self.slo.section(),
               "flight": flight.get_recorder().stats()}
        if self.cache is not None:
            out["cache"] = self.cache.section()
        if self._frontend is not None:
            out["frontend"] = {
                "connections": self._frontend.connections(),
                "io_threads": len(self._frontend.shards)}
        return out

    # -- TCP frontend ------------------------------------------------------
    def start(self) -> int:
        """Bind the event-loop frontend; returns the bound port."""
        host = self.config.get("serve.host", "127.0.0.1")
        port = self.config.get_int("serve.port", 8650)
        self._frontend = EventLoopFrontend(
            self, host, port,
            io_threads=self.config.get_int(KEY_IO_THREADS,
                                           DEFAULT_IO_THREADS),
            backlog=self.config.get_int(KEY_BACKLOG, DEFAULT_BACKLOG),
            pipeline_max=self.config.get_int(KEY_PIPELINE_MAX,
                                             DEFAULT_PIPELINE_MAX))
        if self._reaper_thread is None:
            self._reaper_thread = self._start_reaper()
        self.port = self._frontend.port
        return self.port

    def stop(self, drain: bool = True) -> None:
        """Graceful shutdown: stop accepting, let every already-read
        request complete (bounded by ``serve.drain.timeout.sec``; what
        remains gets a structured drain-timeout error), then stop the
        I/O shards, telemetry, command executor, and the replica pool —
        no queued request is ever silently dropped."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._stop_watchdog.set()
        fe = self._frontend
        if fe is not None:
            fe.begin_drain()
            if drain and not fe.await_drained(self.drain_timeout_s):
                fe.fail_pending(
                    "server draining: request abandoned past "
                    "serve.drain.timeout.sec")
                fe.await_drained(1.0)
            fe.stop()
            self._frontend = None
        # stop the telemetry thread BEFORE the pool closes (its final
        # tick still sees the live batchers); verifiably gone afterwards
        # — the shutdown lint hammers start/stop and asserts no leaked
        # avenir-telemetry thread
        self.telemetry.stop()
        # cache promote workers stop before the pool they build into;
        # queued promotes fail fast with a structured shutdown error
        if self.cache is not None:
            self.cache.close()
        if self._cold_pool is not None:
            self._cold_pool.shutdown(wait=True)
        self._cmd_pool.shutdown(wait=True)
        self.pool.close(drain=False)


class _AsyncCollector:
    """Waits (without a thread) for every future of one multi-row
    submission, then assembles the response and fires the frontend
    callback exactly once — or is force-timed-out by the server's
    reaper when its deadline passes first."""

    __slots__ = ("server", "sub", "cb", "deadline", "_lock", "_left",
                 "_outputs", "_errors", "_timeouts", "_poisons",
                 "_last_err", "_finished")

    def __init__(self, server: PredictionServer, sub: _Submission,
                 cb: Callable[[dict], None],
                 deadline: float = float("inf")):
        self.server = server
        self.sub = sub
        self.cb = cb
        self.deadline = deadline
        self._lock = sanitizer.make_lock("serve.collector")
        self._left = sum(1 for f in sub.futures if f is not None)
        self._outputs: List[Optional[str]] = [None] * len(sub.futures)
        self._errors = 0
        self._timeouts = 0
        self._poisons = 0
        self._last_err = sub.last_err
        self._finished = False

    def arm(self) -> None:
        fire = False
        with self._lock:
            if self._left == 0 and not self._finished:
                self._finished = True
                fire = True
        if fire:
            self._finish()
            return
        for i, f in enumerate(self.sub.futures):
            if f is not None:
                f.add_done_callback(
                    lambda fut, i=i: self._done(i, fut))

    def _done(self, i: int, fut) -> None:
        out: Optional[str] = None
        err = timeout = poison = 0
        last = None
        exc = fut.exception()
        if exc is None:
            out = fut.result()
        else:
            err = 1
            last = str(exc) or f"{type(exc).__name__}"
            if isinstance(exc, (TimeoutError, _FutureTimeout)):
                timeout = 1
                last = str(exc) or "request deadline exceeded"
            elif isinstance(exc, PoisonRowError):
                poison = 1
        with self._lock:
            if self._finished:
                return          # the reaper already answered this one
            self._outputs[i] = out
            self._errors += err
            self._timeouts += timeout
            self._poisons += poison
            if last is not None:
                self._last_err = last
            self._left -= 1
            fire = self._left == 0
            if fire:
                self._finished = True
        if fire:
            self._finish()

    def expire(self) -> None:
        """Reaper entry: convert every still-unresolved row into a
        structured timeout (no-op when the response already fired)."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self._errors += self._left
            self._timeouts += self._left
            self._left = 0
            self._last_err = ("request timed out "
                              "(serve.request.timeout.sec)")
        self._finish()

    def _finish(self) -> None:
        with self.server._inflight_lock:
            self.server._inflight.discard(self)
        try:
            resp = self.server._assemble(
                self.sub, self._outputs, self._errors, self._timeouts,
                self._last_err, self._poisons)
        except Exception as e:                      # noqa: BLE001
            resp = {"error": f"{type(e).__name__}: {e}"}
        self.cb(resp)


# ---------------------------------------------------------------------------
# client helpers (tests, bench, runbook clients)
# ---------------------------------------------------------------------------

def _read_response(sock: socket.socket, complete, timeout: float,
                   what: str) -> bytes:
    """Incremental bounded read: recv until ``complete(buf)`` says the
    response is fully framed.  The deadline applies to the WHOLE read —
    a response missing its terminator surfaces a structured
    :class:`TruncatedResponseError` (carrying the partial bytes) after
    ``timeout`` seconds or on connection close, instead of stalling a
    blocking ``recv`` until the full socket timeout with the partial
    response silently discarded."""
    deadline = time.monotonic() + timeout
    buf = b""
    while not complete(buf):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TruncatedResponseError(
                f"{what}: no complete response within {timeout}s "
                f"({len(buf)} partial bytes)", buf)
        sock.settimeout(remaining)
        try:
            chunk = sock.recv(65536)
        except socket.timeout:
            raise TruncatedResponseError(
                f"{what}: no complete response within {timeout}s "
                f"({len(buf)} partial bytes)", buf) from None
        if not chunk:
            raise TruncatedResponseError(
                f"{what}: connection closed mid-response "
                f"({len(buf)} partial bytes)", buf)
        buf += chunk
    return buf


def request(host: str, port: int, obj: dict, timeout: float = 30.0) -> dict:
    """One-shot client helper: send one JSON request line, read one
    response line (used by tests, the bench, and the runbook client).
    Raises :class:`TruncatedResponseError` when the response line never
    completes within ``timeout``."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(obj) + "\n").encode())
        buf = _read_response(sock, lambda b: b.endswith(b"\n"), timeout,
                             "request")
    return json.loads(buf.decode())


def request_text(host: str, port: int, obj: dict,
                 timeout: float = 30.0) -> str:
    """One-shot client for TEXT responses (the ``metrics`` Prometheus
    exposition): sends one JSON request line, reads until the ``# EOF``
    terminator line — the scrape-loop primitive the telemetry runbook's
    client uses.  If the server answers with a one-line JSON error
    instead of exposition (e.g. ``metrics_text`` itself failed, or the
    cmd was not ``metrics``), that line is returned immediately — the
    caller gets the diagnostic instead of blocking until the read
    deadline waiting for a terminator that will never come.  A response
    that never completes raises :class:`TruncatedResponseError`."""
    terminator = b"# EOF\n"

    def complete(buf: bytes) -> bool:
        return (buf.endswith(terminator)
                or (buf.startswith(b"{") and buf.endswith(b"\n")))

    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(obj) + "\n").encode())
        buf = _read_response(sock, complete, timeout, "request_text")
    return buf.decode()


def serve_main(argv) -> int:
    """``python -m avenir_tpu_torch serve -Dconf.path=serve.properties
    [--device cpu|cuda] [--trace out.json] [--metrics-out series.jsonl]``."""
    from ..cli import (configure_resilience, extract_device_flag,
                       extract_metrics_out_flag, extract_trace_flag)

    argv, device = extract_device_flag(list(argv))
    argv, trace_path = extract_trace_flag(argv)
    argv, metrics_out = extract_metrics_out_flag(argv)
    defines, positional = parse_cli_args(argv)
    if positional and positional[0] in ("-h", "--help"):
        print("usage: python -m avenir_tpu_torch serve -Dconf.path=<serve."
              "properties> [-Dserve.port=N ...] [--device cpu|cuda] "
              "[--trace out.json] [--metrics-out series.jsonl]",
              file=sys.stderr)
        return 2
    config = load_job_config(defines)
    if not (config.get("serve.models") or config.get(KEY_CACHE_MODELS)):
        print("serve: no models configured (serve.models=... for eager "
              "residency, serve.cache.models=... for managed residency)",
              file=sys.stderr)
        return 2
    if metrics_out:
        # the server's own exporter reads the key; the flag just sets it
        config.set(telemetry.KEY_JSONL_PATH, metrics_out)
    obs.configure_from_config(config, force_enable=bool(trace_path))
    # before configure_resilience: the fleet publisher routes
    # flight.dump.dir into its spool feed when fleetobs.spool.dir is set
    from ..fleetobs.publisher import publisher_for_job
    publisher = publisher_for_job(config, role="serve")
    configure_resilience(config)
    server = PredictionServer(config, device=device)
    if publisher is not None:
        publisher.attach(server.telemetry)
    # started only after the server construction succeeded: a model-load
    # failure above must not leak the trace-flush thread
    flusher = telemetry.flusher_for_job(config, trace_path)
    port = server.start()
    names = ", ".join(
        f"{e.name}:{e.version}({e.kind})" for e in server.registry.entries())
    if server.cache is not None:
        cached = len(server.cache.catalog)
        names = (f"{names} + {cached} cached tenants" if names
                 else f"{cached} cached tenants (cold; promote on demand)")
    print(f"serving {names} on "
          f"{config.get('serve.host', '127.0.0.1')}:{port} "
          f"({server.pool.device})", file=sys.stderr, flush=True)
    # explicit shutdown handlers: SIGTERM is the standard operational stop
    # (and triggers the same graceful drain as an in-process stop()), and
    # a backgrounded server (sh's `serve &`) inherits SIGINT as SIG_IGN —
    # installing our own handler re-enables both so the drain (and the
    # --trace export below) runs instead of requiring SIGKILL
    stop_evt = threading.Event()
    import signal
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop_evt.set())
        except (ValueError, OSError):       # non-main thread / platform
            pass
    try:
        stop_evt.wait()
    except KeyboardInterrupt:
        pass
    finally:
        # graceful drain: accepting stops, queued requests complete (or
        # deadline-timeout) before the process exits
        server.stop(drain=True)
        if flusher is not None:
            flusher.stop()
        if trace_path:
            n = obs.get_tracer().export_chrome_trace(trace_path)
            print(f"obs: wrote {n} trace events to {trace_path} "
                  f"(open in chrome://tracing or ui.perfetto.dev)",
                  file=sys.stderr)
        # black-box flush: the SIGTERM/finally path leaves one final
        # flight dump behind (flight.dump.dir configured), so even a
        # killed serve still documents its last seconds
        dump = flight.flush_on_exit()
        if dump:
            print(f"flight: wrote final black-box dump to {dump}",
                  file=sys.stderr)
    return 0
