"""The fleet router: one wire surface over N serving processes.

``python -m avenir_tpu_torch router -Drouter.backends=host:p1,host:p2`` runs
a **torch-free** dispatch tier speaking the existing JSON-lines protocol
on the front (the same :class:`EventLoopFrontend` the prediction server
uses — existing clients and the workload harness connect unchanged) and
the :mod:`backend` connection pools on the back.

Dispatch is least-loaded per model over a demotion ladder mirroring the
in-process variant router (serve/router.py):

1. backends that are CONNECTED and HEALTHY — feed fresh, model neither
   soft-degraded nor in rolling-window SLO violation on that backend
   (:class:`~.watch.FeedWatch` folds each backend's spool feed into a
   per-backend SLO board);
2. else any connected backend;
3. else every configured backend (a reconnect attempt — total darkness
   should produce connection errors, not silent drops).

Responses relay VERBATIM (byte parity with a direct backend
connection).  When a backend dies mid-request, idempotent scoring
requests (no ``cmd``) retry on a sibling up to ``router.retry.max``
times — the zero-dropped-innocents contract under a backend SIGKILL;
command requests never retry (a ``reload`` must not double-fire).  The
router answers ``stats``/``health``/``metrics`` itself (fan-out +
merge), fans lifecycle commands (``reload``/``promote``/``demote``/
``scale``) to every backend, and forwards unknown commands (subsystem
extensions, e.g. the stream tier's ``feedback``) to one backend
without retry.

Each forward is traced as a router-minted ``router.forward`` span
joined to the client's ``trace_id`` when it carries one, so a request's
fan-out stitches across the router and backend lanes in
``fleetobs stitch``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from ...core import flight, obs, sanitizer, telemetry
from ...core.config import load_job_config, parse_cli_args
from ...core.obs import LatencyHistogram
from ...fleetobs.publisher import KEY_SPOOL_DIR, publisher_for_job
from .backend import (DEFAULT_CONNECTIONS, DEFAULT_REQUEST_TIMEOUT,
                      KEY_BACKENDS, KEY_CONNECTIONS, KEY_REQUEST_TIMEOUT,
                      BackendLink, parse_backends)
from .control import ControlLoop
from .lease import RouterLease
from .watch import FeedWatch

KEY_HOST = "router.host"
KEY_PORT = "router.port"
KEY_RETRY_MAX = "router.retry.max"
KEY_DRAIN_TIMEOUT = "router.drain.timeout.sec"

DEFAULT_RETRY_MAX = 1
DEFAULT_DRAIN_TIMEOUT = 5.0

ROUTER_GROUP = "Router"

#: commands the router fans out to EVERY backend (all idempotent to
#: fan, though never to RETRY — quarantine seeding folds by max, so
#: fanning it wide is exactly its propagation semantics)
FANOUT_CMDS = ("reload", "promote", "demote", "scale", "quarantine")


class FleetRouter:
    """``dispatch_line``/``max_line_bytes`` surface over backend links
    (duck-typed for :class:`EventLoopFrontend`)."""

    max_line_bytes = 1 << 20

    def __init__(self, config, identity_label: Optional[str] = None):
        backends = parse_backends(config.get(KEY_BACKENDS))
        if not backends:
            raise ValueError(
                "router.backends must list at least one host:port")
        n_conns = config.get_int(KEY_CONNECTIONS, DEFAULT_CONNECTIONS)
        self.links: List[BackendLink] = [
            BackendLink(h, p, n_conns) for h, p in backends]
        self._by_name = {link.name: link for link in self.links}
        self.retry_max = max(0, config.get_int(KEY_RETRY_MAX,
                                               DEFAULT_RETRY_MAX))
        self.request_timeout = config.get_float(KEY_REQUEST_TIMEOUT,
                                                DEFAULT_REQUEST_TIMEOUT)
        spool = config.get(KEY_SPOOL_DIR)
        self.watch: Optional[FeedWatch] = (
            FeedWatch(config, spool, [link.name for link in self.links])
            if spool else None)
        # replicated routers share the spool: a lease file elects the
        # ONE autoscale/residency leader (followers dispatch only).
        # Without a spool — or without a fleetobs identity to hold the
        # lease under — there is nothing to share, so this router is
        # leader by construction (lease None => ControlLoop leads)
        self.lease: Optional[RouterLease] = (
            RouterLease(config, spool, identity_label)
            if spool and identity_label else None)
        self.control = ControlLoop(config, self.links, self.watch,
                                   self._take_rates, lease=self.lease)
        self._lock = sanitizer.make_lock("fleet.router")
        self._counts: Dict[str, int] = {}       # model -> forwards ever
        self._rate_base: Dict[str, int] = {}
        self._rate_t = time.monotonic()
        self._counters: Dict[str, int] = {
            "Forwarded": 0, "Retries": 0, "Retry successes": 0,
            "Backend lost": 0, "No backend": 0}
        self._hists: Dict[str, LatencyHistogram] = {}
        self._cmd_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="avenir-fleet-cmd")
        self.frontend = None        # attached by router_main

    # -- arrival-rate accounting (the autoscaler's input) -------------------
    def _take_rates(self) -> Dict[str, float]:
        """Per-model forwards/sec since the LAST call (resets the
        window; called once per control tick)."""
        now = time.monotonic()
        with self._lock:
            dt = max(now - self._rate_t, 1e-6)
            rates = {}
            for model, n in self._counts.items():
                d = n - self._rate_base.get(model, 0)
                if d > 0:
                    rates[model] = d / dt
            self._rate_base = dict(self._counts)
            self._rate_t = now
        return rates

    # -- dispatch ----------------------------------------------------------
    def dispatch_line(self, line: str, cb: Callable[[object], None],
                      conn=None) -> Optional[dict]:
        try:
            obj = json.loads(line)
            if not isinstance(obj, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            cb({"error": f"bad request: {exc}"})
            return None
        rid = obj.get("request_id")
        meta = {"request_id": rid} if rid is not None else None
        cmd = obj.get("cmd")
        if cmd is None:
            self._route(obj, line, cb)
            return meta
        if cmd == "metrics":
            cb({"_text": telemetry.prometheus_text(
                telemetry.build_snapshot()
                if self._overlay_into is None
                else self._overlay_into.snapshot())})
            return meta
        if cmd in ("stats", "health"):
            self._submit_cmd(lambda: cb(self._aggregate(cmd)), cb, rid)
            return meta
        if cmd in FANOUT_CMDS:
            self._submit_cmd(lambda: cb(self._fanout(obj, rid)), cb, rid)
            return meta
        # subsystem extension command: ONE backend, never retried (the
        # router cannot know it is idempotent)
        self._route(obj, line, cb, retries=0)
        return meta

    _overlay_into = None        # the exporter serving metrics snapshots

    def _submit_cmd(self, fn, cb, rid) -> None:
        try:
            self._cmd_pool.submit(self._guarded, fn)
        except RuntimeError:    # pool shut down mid-drain
            err = {"error": "router shutting down", "timeout": True}
            if rid is not None:
                err["request_id"] = rid
            cb(err)

    @staticmethod
    def _guarded(fn) -> None:
        try:
            fn()
        except Exception:                               # noqa: BLE001
            pass                # the cb owns error rendering

    # -- the predict path ---------------------------------------------------
    def _pick(self, model: Optional[str],
              exclude: set) -> Optional[BackendLink]:
        """The demotion ladder: healthy -> connected -> all, least
        in-flight within the chosen rung, excluding already-tried."""
        links = [link for link in self.links if link.name not in exclude]
        if not links:
            return None
        # health over ALL candidates, not just dialed ones: links
        # connect lazily in send(), so a feed-healthy backend that was
        # never dialed yet must still outrank a connected-but-demoted one
        connected = [link for link in links if link.alive()]
        if self.watch is not None:
            healthy = [link for link in links
                       if self.watch.healthy(link.name, model)]
        else:
            healthy = connected
        ladder = healthy or connected or links
        return min(ladder, key=lambda link: link.inflight())

    def _route(self, obj: dict, line: str,
               cb: Callable[[object], None],
               retries: Optional[int] = None) -> None:
        model = obj.get("model") if isinstance(obj.get("model"), str) \
            else None
        payload = (line if line.endswith("\n") else line + "\n").encode()
        budget = self.retry_max if retries is None else retries
        raw_trace = obj.get("trace_id")
        ctx = (obs.new_trace_context(raw_trace)
               if isinstance(raw_trace, str) and raw_trace else None)
        tried: set = set()
        t0_ns = time.perf_counter_ns()

        def attempt(left: int) -> None:
            link = self._pick(model, tried)
            if link is None:
                self._bump("No backend")
                cb(self._lost_response(obj, "no backend available"))
                return
            tried.add(link.name)

            def on_resp(raw: Optional[bytes], link=link) -> None:
                if raw is None:
                    link.note_lost()
                    self._bump("Backend lost")
                    flight.record("fleet.backend_lost",
                                  backend=link.name, model=model,
                                  retry_left=left)
                    if left > 0:
                        self._bump("Retries")
                        attempt(left - 1)
                    else:
                        cb(self._lost_response(
                            obj, f"backend {link.name} lost "
                                 f"mid-request"))
                    return
                if tried != {link.name}:
                    self._bump("Retry successes")
                self._observe(model, link, ctx, t0_ns)
                text = raw.decode("utf-8", errors="replace")
                # verbatim relay: the client sees the backend's exact
                # response line (byte parity with a direct connection)
                cb({"_text": text[:-1] if text.endswith("\n") else text})

            if not link.send(payload, on_resp):
                # could not even transmit: not a retry, just the ladder
                # moving on (tried-set growth bounds the recursion)
                attempt(left)
                return
            with self._lock:
                self._counters["Forwarded"] += 1
                key = model or "_default"
                self._counts[key] = self._counts.get(key, 0) + 1

        attempt(budget)

    def _observe(self, model: Optional[str], link: BackendLink,
                 ctx, t0_ns: int) -> None:
        dur_ns = time.perf_counter_ns() - t0_ns
        key = model or "_default"
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = LatencyHistogram()
        hist.record(dur_ns / 1e9,
                    trace_id=ctx.trace_id if ctx is not None else None)
        tracer = obs.get_tracer()
        if tracer.enabled and (ctx is None or ctx.sampled):
            attrs = {"backend": link.name}
            if model:
                attrs["model"] = model
            tracer.record_span("router.forward", t0_ns, dur_ns,
                               ctx=ctx, **attrs)

    def _lost_response(self, obj: dict, msg: str) -> dict:
        resp = {"error": msg, "backend_lost": True, "degraded": True}
        rid = obj.get("request_id")
        if rid is not None:
            resp["request_id"] = rid
        trace = obj.get("trace_id")
        if isinstance(trace, str) and trace:
            resp["trace_id"] = trace
        flight.record("wire.error", error=msg,
                      model=obj.get("model"), backend_lost=True)
        return resp

    def _bump(self, name: str) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + 1

    # -- aggregated command surface ------------------------------------------
    def _fanout(self, obj: dict, rid) -> dict:
        """Send a lifecycle command to EVERY backend; per-backend
        responses keyed by backend name."""
        out: Dict[str, dict] = {}
        ok = True
        for link in self.links:
            resp = link.command(obj, self.request_timeout)
            if resp is None:
                resp = {"error": f"backend {link.name} unreachable"}
            out[link.name] = resp
            ok = ok and "error" not in resp
        result = {"ok": ok, "cmd": obj.get("cmd"), "backends": out}
        if rid is not None:
            result["request_id"] = rid
        return result

    @staticmethod
    def _merge_counters(dst: Dict[str, Dict[str, int]],
                        src: Dict) -> None:
        for group, names in (src or {}).items():
            if not isinstance(names, dict):
                continue
            bucket = dst.setdefault(str(group), {})
            for k, v in names.items():
                if isinstance(v, (int, float)):
                    bucket[str(k)] = bucket.get(str(k), 0) + int(v)

    def _aggregate(self, cmd: str) -> dict:
        """Fan ``stats``/``health`` out and merge: per-backend detail
        plus fleet-summed per-model counters, so harness consumers (e.g.
        the workload runner's compile counting) read the router exactly
        like a single backend."""
        per_backend: Dict[str, dict] = {}
        for link in self.links:
            resp = link.command({"cmd": cmd}, self.request_timeout)
            per_backend[link.name] = (
                resp if resp is not None
                else {"error": f"backend {link.name} unreachable"})
        if cmd == "health":
            ok = any(isinstance(r, dict) and r.get("ok")
                     for r in per_backend.values())
            return {"ok": ok, "backends": per_backend,
                    "router": self.section()}
        models: Dict[str, dict] = {}
        compiles = 0
        tier_seen = False
        for resp in per_backend.values():
            if not isinstance(resp, dict):
                continue
            for name, sec in (resp.get("models") or {}).items():
                dst = models.setdefault(name, {"counters": {}})
                self._merge_counters(dst["counters"],
                                     (sec or {}).get("counters"))
            tier = (resp.get("cache") or {}).get("compile_tier")
            if isinstance(tier, dict):
                tier_seen = True
                compiles += int(tier.get("compiles", 0))
        out = {"models": models, "backends": per_backend,
               "router": self.section()}
        if tier_seen:
            out["cache"] = {"compile_tier": {"compiles": compiles}}
        return out

    def section(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
        sec = {"backends": {link.name: link.section()
                            for link in self.links},
               "counters": counters,
               "control": self.control.section()}
        if self.lease is not None:
            sec["lease"] = self.lease.section()
        if self.watch is not None:
            sec["watch"] = self.watch.section()
        if self.frontend is not None:
            sec["connections"] = self.frontend.connections()
        return sec

    # -- telemetry overlay (the router's own feed + metrics) ----------------
    def overlay(self) -> dict:
        now = time.time()
        gauges: Dict[str, dict] = {}
        hists: Dict[str, dict] = {}

        def g(name, value, **labels):
            gauges[telemetry.labeled(name, **labels)] = {
                "value": float(value), "ts": now}

        g("router.backends", len(self.links))
        for link in self.links:
            sec = link.section()
            g("router.backend.alive", 1 if sec["alive"] else 0,
              backend=link.name)
            g("router.backend.inflight", sec["inflight"],
              backend=link.name)
            g("router.backend.lost", sec["lost"], backend=link.name)
        if self.watch is not None:
            wsec = self.watch.section()
            for name, view in wsec["backends"].items():
                g("router.feed.stale", 1 if view["stale"] else 0,
                  backend=name)
        if self.lease is not None:
            lsec = self.lease.section()
            g("router.lease.leader", 1 if lsec["leader"] else 0)
            g("router.lease.generation", lsec["generation"])
        if self.frontend is not None:
            g("router.frontend.connections",
              self.frontend.connections())
        with self._lock:
            counters = {ROUTER_GROUP: dict(self._counters)}
            for model, hist in self._hists.items():
                hists[telemetry.labeled("router.forward.latency",
                                        model=model)] = hist.state_dict()
        return {"gauges": gauges, "hists": hists, "counters": counters}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self.watch is not None:
            self.watch.start()
        if self.lease is not None:
            # the lease settles BEFORE the first control tick, so a
            # follower never runs one leaderly tick at startup
            self.lease.start()
        self.control.start()
        return self

    def stop(self) -> None:
        self.control.stop()
        if self.lease is not None:
            # after control (no tick may re-assert leadership), before
            # the watch dies: release() expires our lease in place so a
            # follower promotes on its next tick instead of waiting TTL
            self.lease.stop()
        if self.watch is not None:
            self.watch.stop()
        self._cmd_pool.shutdown(wait=True)
        for link in self.links:
            link.close()


def router_main(argv) -> int:
    """``python -m avenir_tpu_torch router -Drouter.backends=host:p1,host:p2
    [-Drouter.port=N] [-Dfleetobs.spool.dir=<dir> ...]``."""
    from ...cli import configure_resilience

    defines, positional = parse_cli_args(list(argv))
    if positional and positional[0] in ("-h", "--help"):
        print("usage: python -m avenir_tpu_torch router "
              "-Drouter.backends=host:p1,host:p2 [-Drouter.port=N] "
              "[-Dfleetobs.spool.dir=<dir>] [-Drouter.autoscale."
              "enable=true ...]", file=sys.stderr)
        return 2
    config = load_job_config(defines)
    if not config.get(KEY_BACKENDS):
        print("router: no backends configured "
              "(-Drouter.backends=host:port,host:port)", file=sys.stderr)
        return 2
    obs.configure_from_config(config)
    # before configure_resilience: the publisher routes flight.dump.dir
    # into the router's own spool feed (role "router"), exactly like a
    # serving process — the router is one more lane in the stitched
    # fleet timeline
    publisher = publisher_for_job(config, role="router")
    configure_resilience(config)
    telemetry.configure_from_config(config)

    router = FleetRouter(
        config,
        identity_label=publisher.identity.label
        if publisher is not None else None)
    exporter = telemetry.TelemetryExporter(
        config.get_float(telemetry.KEY_INTERVAL,
                         telemetry.DEFAULT_INTERVAL_SEC),
        jsonl_path=config.get(telemetry.KEY_JSONL_PATH),
        providers=[router.overlay])
    if publisher is not None:
        publisher.attach(exporter)
    exporter.start()
    router._overlay_into = exporter
    router.start()

    from ..frontend import DEFAULT_IO_THREADS, KEY_IO_THREADS, \
        EventLoopFrontend
    frontend = EventLoopFrontend(
        router, config.get(KEY_HOST, "127.0.0.1"),
        config.get_int(KEY_PORT, 0),
        io_threads=config.get_int(KEY_IO_THREADS, DEFAULT_IO_THREADS))
    router.frontend = frontend
    names = ", ".join(link.name for link in router.links)
    print(f"router: fronting {len(router.links)} backend(s) [{names}] "
          f"on {config.get(KEY_HOST, '127.0.0.1')}:{frontend.port} "
          f"(retry {router.retry_max}, "
          f"feeds {'on' if router.watch else 'off'}, "
          f"lease {'on' if router.lease else 'off'})",
          file=sys.stderr, flush=True)

    stop_evt = threading.Event()
    import signal
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop_evt.set())
        except (ValueError, OSError):
            pass
    try:
        stop_evt.wait()
    except KeyboardInterrupt:
        pass
    finally:
        # the server's drain discipline: stop accepting, let in-flight
        # forwards resolve, convert whatever is left into structured
        # drain errors — no client ever hangs on a half-shut router
        frontend.begin_drain()
        drain = config.get_float(KEY_DRAIN_TIMEOUT,
                                 DEFAULT_DRAIN_TIMEOUT)
        if not frontend.await_drained(drain):
            frontend.fail_pending(
                "router drain timeout: request abandoned")
            frontend.await_drained(1.0)
        frontend.stop()
        router.stop()
        exporter.stop()
        dump = flight.flush_on_exit()
        if dump:
            print(f"flight: wrote final black-box dump to {dump}",
                  file=sys.stderr)
    return 0


__all__ = ["FleetRouter", "router_main"]
