"""The streaming decision service: ``python -m avenir_tpu_torch stream``,
the port of ``avenir_tpu/stream/service.py``.

Composes the serving stack with the feedback loop:

- a :class:`~avenir_tpu_torch.serve.server.PredictionServer` serving
  ``decide`` requests over the event-loop frontend/pool/router path
  through a ``banditDecision`` model (auto-declared from the
  ``stream.*`` manifest when the config names no ``serve.models``);
- a :class:`~avenir_tpu_torch.stream.consumer.FeedbackConsumer` daemon
  thread folding reward events from the Redis stream into the shared
  :class:`~avenir_tpu_torch.stream.posterior.PosteriorStore` (on
  ``cuda:0`` unless ``--device cpu``) with exactly-once checkpointing;
- two frontend command extensions: ``{"cmd": "feedback", "event":
  "tenant,arm,reward"[, "trace": ...]}`` XADDs a reward event into the
  feedback stream through the service's transport (the runbook path
  when no external producer owns a Redis connection — the event still
  flows through XREADGROUP like any other), and ``{"cmd": "stream"}``
  reports consumer offsets/counters/regret plus a posterior audit.

Redis wiring: ``stream.redis.host``/``stream.redis.port`` name a real
server (the optional ``redis`` package); when no host is configured the
service runs against an in-process :class:`~avenir_tpu_torch.models.
streaming.FakeRedis` — same stream semantics, no dependency — which the
``feedback`` command feeds.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

from ..core import flight, obs, telemetry
from ..core.config import JobConfig, load_job_config, parse_cli_args
from ..models.streaming import FakeRedis, RedisStreamTransport
from .consumer import (DEFAULT_CONSUMER, DEFAULT_GROUP, DEFAULT_STREAM,
                       FeedbackConsumer, KEY_CONSUMER, KEY_GROUP,
                       KEY_STREAM, checkpointer_from_config)
from .posterior import (DEFAULT_STORE, KEY_STORE, PosteriorStore,
                        ensure_store)

KEY_REDIS_HOST = "stream.redis.host"
KEY_REDIS_PORT = "stream.redis.port"
KEY_MODEL_NAME = "stream.model.name"

DEFAULT_MODEL_NAME = "decisions"
DEFAULT_REDIS_PORT = 6379


def transport_from_config(config, client=None) -> RedisStreamTransport:
    """The feedback-stream transport: a real server when
    ``stream.redis.host`` is set, else the in-process FakeRedis."""
    host = config.get(KEY_REDIS_HOST)
    if client is None and not host:
        client = FakeRedis()
    return RedisStreamTransport(
        host or "127.0.0.1",
        config.get_int(KEY_REDIS_PORT, DEFAULT_REDIS_PORT),
        config.get(KEY_STREAM, DEFAULT_STREAM),
        config.get(KEY_GROUP, DEFAULT_GROUP),
        config.get(KEY_CONSUMER, DEFAULT_CONSUMER),
        client=client)


def declare_decision_model(config: JobConfig) -> str:
    """Auto-declare the served ``banditDecision`` model from the
    ``stream.*`` manifest when the config names no ``serve.models`` —
    the one-properties-file service shape the runbook uses.  Returns the
    model name serving decide requests."""
    name = config.get(KEY_MODEL_NAME, DEFAULT_MODEL_NAME)
    if not config.get("serve.models"):
        config.set("serve.models", name)
        config.set(f"serve.model.{name}.kind", "banditDecision")
        config.set(f"serve.model.{name}.stream.store",
                   config.get(KEY_STORE, DEFAULT_STORE))
    return name


class StreamDecisionService:
    """One process's streaming decision service: shared posterior store
    + serving stack + feedback consumer thread."""

    def __init__(self, config: JobConfig, device=None, mesh=None,
                 client=None):
        from ..serve.server import PredictionServer

        self.config = config
        self.store: PosteriorStore = ensure_store(config, device=device,
                                                  mesh=mesh)
        self.model_name = declare_decision_model(config)
        self.transport = transport_from_config(config, client=client)
        self.transport.ensure_group()
        default_ckpt = os.path.join(
            os.getcwd(), f"stream-{self.store.key}.ckpt")
        self.consumer = FeedbackConsumer(
            config, self.store, self.transport,
            checkpointer=checkpointer_from_config(config, self.store,
                                                  default_ckpt))
        # FakeRedis mode: the in-process broker's id clock restarts at 1
        # each process while the checkpoint watermark carries the
        # previous epoch's ids (a real server's ms-based ids are
        # monotonic across restarts) — advance the fake clock past the
        # watermark so post-resume events are never mistaken for
        # duplicates
        from ..models.streaming import _sid
        client = self.transport._r
        if isinstance(client, FakeRedis):
            client.advance_id_clock(self.transport.stream,
                                    _sid(self.consumer.last_applied)[0])
        self.server = PredictionServer(config, device=self.store.device)
        self.server.command_extensions["feedback"] = self._feedback_cmd
        self.server.command_extensions["stream"] = self._stream_cmd
        self._consumer_thread: Optional[threading.Thread] = None

    # -- frontend command extensions ---------------------------------------
    def _feedback_cmd(self, obj: dict) -> dict:
        """XADD one reward event (``event``: ``tenant,arm,reward``;
        optional ``trace``: the decide response's trace id, joining the
        decision to its reward) into the feedback stream."""
        event = obj.get("event")
        if not isinstance(event, str) or event.count(",") < 2:
            return {"error": '"event" must be a '
                             '"tenant,arm,reward" string'}
        fields = {"data": event}
        trace = obj.get("trace")
        if isinstance(trace, str) and trace:
            fields["trace"] = trace
        eid = self.transport.publish(fields)
        return {"ok": True, "id": eid}

    def _stream_cmd(self, _obj: dict) -> dict:
        """Consumer offsets/counters/regret + a posterior audit (the
        per-(tenant, arm) pulls and reward sums, in the canonical
        emitted-line format so operators can diff it against a batch
        replay byte-for-byte)."""
        return {"ok": True,
                "store": self.store.key,
                "model": self.model_name,
                "consumer": self.consumer.stats(),
                "stream_length": self.transport.length(),
                "pending": self.transport.pending_count(),
                "posterior": self.store.host_posterior().lines()}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        """Bind the TCP frontend and start the consumer thread; returns
        the bound port."""
        if self.store.device.type == "cuda":
            self.store.prepare_fold(self.consumer.batch)
        port = self.server.start()
        t = threading.Thread(target=self._consume,
                             name="stream-feedback", daemon=True)
        self._consumer_thread = t
        t.start()
        return port

    def _consume(self) -> None:
        try:
            self.consumer.run(idle_timeout=None)
        except BaseException as exc:               # noqa: BLE001 — the
            # consumer thread's death is an anomaly the black box must
            # document (the serving half keeps answering decide requests
            # from the last-folded posterior)
            flight.trigger("stream-consumer-death", force=True,
                           error=f"{type(exc).__name__}: {exc}")
            raise

    def stop(self) -> None:
        """Graceful stop: the consumer writes its final checkpoint (a
        clean stop resumes exactly), then the server drains."""
        self.consumer.stop()
        t = self._consumer_thread
        if t is not None:
            t.join(timeout=10.0)
            self._consumer_thread = None
        self.server.stop(drain=True)


def stream_main(argv) -> int:
    """``python -m avenir_tpu_torch stream -Dconf.path=stream.properties
    [--device cpu|cuda] [--trace out.json] [--metrics-out series.jsonl]
    [--resume]``."""
    from ..cli import (configure_resilience, extract_device_flag,
                       extract_metrics_out_flag, extract_resume_flag,
                       extract_trace_flag)

    argv, device = extract_device_flag(list(argv))
    argv, trace_path = extract_trace_flag(argv)
    argv, metrics_out = extract_metrics_out_flag(argv)
    argv, resume = extract_resume_flag(argv)
    defines, positional = parse_cli_args(argv)
    if positional and positional[0] in ("-h", "--help"):
        print("usage: python -m avenir_tpu_torch stream -Dconf.path=<stream."
              "properties> [-Dserve.port=N ...] [--device cpu|cuda] "
              "[--trace out.json] [--metrics-out series.jsonl] [--resume]",
              file=sys.stderr)
        return 2
    config = load_job_config(defines)
    if resume:
        config.set("checkpoint.resume", "true")
    if metrics_out:
        config.set(telemetry.KEY_JSONL_PATH, metrics_out)
    obs.configure_from_config(config, force_enable=bool(trace_path))
    # before configure_resilience: the fleet publisher routes
    # flight.dump.dir into its spool feed when fleetobs.spool.dir is set
    from ..fleetobs.publisher import publisher_for_job
    publisher = publisher_for_job(config, role="stream")
    configure_resilience(config)
    service = StreamDecisionService(config, device=device)
    if publisher is not None:
        publisher.attach(service.server.telemetry)
    flusher = telemetry.flusher_for_job(config, trace_path)
    port = service.start()
    print(f"streaming decisions for model {service.model_name!r} "
          f"({len(service.store.tenants)} tenants x "
          f"{len(service.store.arms)} arms, {service.store.algorithm}) on "
          f"{config.get('serve.host', '127.0.0.1')}:{port} "
          f"({service.store.device})",
          file=sys.stderr, flush=True)
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
        service.stop()
        if flusher is not None:
            flusher.stop()
        if trace_path:
            n = obs.get_tracer().export_chrome_trace(trace_path)
            print(f"obs: wrote {n} trace events to {trace_path} "
                  f"(open in chrome://tracing or ui.perfetto.dev)",
                  file=sys.stderr)
        dump = flight.flush_on_exit()
        if dump:
            print(f"flight: wrote final black-box dump to {dump}",
                  file=sys.stderr)
    return 0
