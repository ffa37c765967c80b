"""The program's prediction server under open-loop single-row traffic.

Set-up generates the served model's training rows and the request pool
from the seed (``gen/<config>``), trains the served model with the
program's own job, and starts ``PredictionServer`` in this process as
``python -m avenir_tpu_torch serve`` starts it (its warm-up builds every
bucket's scorer).  It then starts the load generator
(``harness/client.py``, a child process of standard-library Python) and
waits until its connections are open.

The window is the generator's schedule (``harness/traffic.py``): each
request is one pool row, pinned to a variant, sent when due over
``conns`` persistent connections.  The generator waits up to
``drain_s`` after the window for the last answers.

- ``serve_p50_ms``, ``serve_p99_ms``: percentiles of the latency of
  every request due in the window, from its due time to its whole
  response at the client; a failed or unanswered request is infinitely
  late.
- ``serve_goodput_rows_per_s``: rows answered without error within the
  deployment's declared p99 target (``serve.slo.p99.ms`` of the cell's
  ``serve_properties``) over the window's seconds.

``correct``: every answer against the reference (``refs/<config>``):
``judge_serve`` over the requests' pool rows and variants.

A traced run records the program's spans over the window, then offers a
burst of ``SERVE_TRACE_SECONDS`` of the same traffic under
``torch.profiler``: the device's busy and idle time come from the
burst.  Its answers are judged too.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from harness import common, traffic
from harness.devtrace import SERVE_TRACE_SECONDS, DeviceTrace
from harness.layer import LayerContext
from harness.setup import run_job, write_config_files, write_rows
from harness.stats import percentile

CLIENT = Path(__file__).resolve().parent.parent / "harness" / "client.py"
TRACE_SPANS = 1 << 23


class Server:
    """The served deployment of one run: its model trained, the server
    up, the pool and its reference ready."""

    def __init__(self, ctx):
        self.ctx = ctx
        p, cfg = ctx.params, ctx.config
        self.gen, self.ref = ctx.module("gen"), ctx.module("refs")
        self.pool_n = traffic.pool_size(p)
        data = self.gen.make(ctx.seed, int(cfg["assumed"][p["rows_key"]]),
                             self.pool_n)
        self.train, self.pool = data["train"], data["pool"]
        work = ctx.work
        in_dir = write_rows(work / "train", self.gen.csv_bytes(self.train, b"T"))
        model_dir = work / "model"
        paths = write_config_files(cfg, work, {"@model": str(model_dir)})
        dev = str(ctx.device)
        run_job(p["train_job"], paths[p["train_properties"]], in_dir,
                model_dir, dev)
        self.pool_lines = self.gen.csv_bytes(self.pool, p["id_prefix"].encode()
                                             ).decode().splitlines()

        from avenir_tpu_torch.cli import cli_mesh, configure_resilience
        from avenir_tpu_torch.core import obs
        from avenir_tpu_torch.core.config import load_job_config
        from avenir_tpu_torch.serve.server import PredictionServer

        defines = {"conf.path": str(paths[p["serve_properties"]]),
                   "serve.port": "0"}
        if ctx.trace:
            defines.update({"obs.trace.enable": "true",
                            "obs.trace.buffer.spans": str(TRACE_SPANS)})
        config = load_job_config(defines)
        obs.configure_from_config(config)
        configure_resilience(config)
        self.server = PredictionServer(config, device=dev, mesh=cli_mesh(dev))
        self.port = self.server.start()
        self.host = config.get("serve.host", "127.0.0.1")

    def requests(self, rows, variants):
        """The request lines.  ``send_variant`` (the control only) pins
        a request to another variant than the one it is judged as."""
        model = self.ctx.params["model"]
        swap = self.ctx.params.get("send_variant", {})
        return [json.dumps({"model": model, "row": self.pool_lines[r],
                            "variant": swap.get(v, v)})
                for r, v in zip(rows, variants)]

    def stop(self):
        self.server.stop(drain=True)


def goodput_ms(ctx) -> float:
    """The latency within which an answer counts toward goodput: the
    ``serve.slo.p99.ms`` that the cell's serving properties declare."""
    return float(ctx.config["files"][ctx.params["serve_properties"]]
                 ["serve.slo.p99.ms"])


def open_loop(server: Server, rate: float, seconds: float, seed: int,
              on_go=None, drain_s: float = 60.0, tag: str = "") -> dict:
    """One window at ``rate`` requests a second: the schedule from
    ``seed``, the generator started and given ``go`` (``on_go`` runs
    just before); returns the schedule and the client's records."""
    ctx = server.ctx
    params = dict(ctx.params, rate=rate)
    offsets, rows, variants = traffic.schedule(params, seconds, seed,
                                               server.pool_n)
    d = ctx.work / f"client-{rate:g}{tag}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "offsets.txt").write_text("\n".join(repr(float(v)) for v in offsets))
    (d / "requests.txt").write_text("\n".join(server.requests(rows, variants)))
    spec = {"host": server.host, "port": server.port,
            "conns": int(params.get("conns", 64)),
            "offsets_path": str(d / "offsets.txt"),
            "requests_path": str(d / "requests.txt"),
            "seconds": seconds, "drain_s": drain_s,
            "out_path": str(d / "out.json")}
    (d / "spec.json").write_text(json.dumps(spec))
    proc = subprocess.Popen([sys.executable, str(CLIENT), str(d / "spec.json")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("load generator did not connect")
        if on_go is not None:
            on_go()
        proc.stdin.write("go\n")
        proc.stdin.flush()
        t_go = time.perf_counter_ns()
        done = proc.stdout.readline().strip()
        t_done = time.perf_counter_ns()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if done != "done" or proc.returncode != 0:
        raise RuntimeError(f"load generator failed (exit {proc.returncode})")
    with open(d / "out.json") as fh:
        rec = json.load(fh)
    return {"offsets": offsets, "rows": rows, "variants": variants,
            "rec": rec, "t_go_ns": t_go, "t_done_ns": t_done}


def parse_response(text: Optional[str]) -> Optional[dict]:
    """One response line as the object it holds; None for no answer, an
    object with no ``output`` for a line that is not one."""
    if text is None:
        return None
    try:
        obj = json.loads(text)
    except ValueError:
        return {"output": None}
    return obj if isinstance(obj, dict) else {"output": None}


def summarize(win: dict, seconds: float, slo_ms: float) -> dict:
    """Latencies, failures and goodput of one window."""
    offsets, rec = win["offsets"], win["rec"]
    answers = [parse_response(t) for t in rec["responses"]]
    lat, ok_in_time, failed = [], 0, 0
    late_send = []
    backlog = 0
    per_second = [0.0] * (int(math.ceil(seconds)) or 1)
    for k, due in enumerate(offsets):
        r, a = rec["recv"][k], answers[k]
        if rec["sent"][k] is not None:
            late_send.append(rec["sent"][k] - due)
        due = float(due)
        sec = min(int(due), len(per_second) - 1)
        per_second[sec] = max(per_second[sec],
                              math.inf if r is None else r - due)
        if r is None or r > seconds:
            backlog += 1
        if a is None or "error" in a:
            failed += 1
            lat.append(math.inf)
            continue
        v = r - due
        lat.append(v)
        ok_in_time += v * 1e3 <= slo_ms
    return {"answers": answers, "n": len(offsets), "failed": failed,
            "p50_ms": percentile(lat, 50) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3,
            "goodput": ok_in_time / seconds,
            "backlog_at_close": backlog,
            "send_late_p99_ms": (percentile(late_send, 99) * 1e3
                                 if late_send else math.nan),
            "send_late_max_ms": max(late_send, default=math.nan) * 1e3,
            "max_ms_by_second": [round(v * 1e3, 1) for v in per_second]}


def run(ctx) -> dict:
    p = ctx.params
    server = Server(ctx)
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    trace = DeviceTrace(ctx.device)
    state = {}

    def on_go():
        if ctx.trace:
            from avenir_tpu_torch.core import obs
            obs.get_tracer().clear()
        state["setup_s"] = time.perf_counter() - ctx.t_start

    try:
        win = open_loop(server, float(p["rate"]), ctx.seconds, ctx.seed,
                        on_go=on_go)
        burst = None
        if ctx.trace:
            # the device trace: a burst of the same traffic after the
            # window, the trace started while the server is idle and read
            # back once the burst is answered (starting or reading a trace
            # under load stalls this process's server for seconds)
            burst = open_loop(server, float(p["rate"]), SERVE_TRACE_SECONDS,
                              ctx.seed + 1, on_go=trace.start, tag="-trace")
            trace.stop()
        device = common.card_description(ctx.device)
        layer = None
        if ctx.trace:
            from avenir_tpu_torch.core import obs
            layer = LayerContext(obs.get_tracer().spans(), trace,
                                 win["t_go_ns"], win["t_done_ns"],
                                 {"requests": len(win["offsets"])},
                                 ctx.config, device_window=(
                                     trace.start_ns, trace.end_ns))
            obs.get_tracer().clear()
    finally:
        server.stop()
    slo_ms = goodput_ms(ctx)
    s = summarize(win, ctx.seconds, slo_ms)
    common.log(f"p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms; "
               f"requests {s['n']} failed {s['failed']} backlog at close "
               f"{s['backlog_at_close']} send lateness p99 "
               f"{s['send_late_p99_ms']:.3f} ms max "
               f"{s['send_late_max_ms']:.3f} ms; slowest answer a second "
               f"(ms): {s['max_ms_by_second']}")
    answers, rows, variants = s["answers"], list(win["rows"]), \
        list(win["variants"])
    attempted, failed = s["n"], s["failed"]
    if burst is not None:
        b = summarize(burst, SERVE_TRACE_SECONDS, slo_ms)
        answers = answers + b["answers"]
        rows += list(burst["rows"])
        variants += list(burst["variants"])
        attempted += b["n"]
        failed += b["failed"]
    if layer is not None:
        # the window's tails, timed at the client
        layer.facts.update(p50_ms=s["p50_ms"], p99_ms=s["p99_ms"])
    del server.server
    gc.collect()
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the server is down
    scorer = server.ref.Scorer(server.train)
    checks = server.ref.judge_serve(answers, np.asarray(rows), variants,
                                    scorer, server.pool, p["id_prefix"])
    return {"setup_s": state["setup_s"],
            "end_to_end": {"setup_s": state["setup_s"],
                           "serve_p50_ms": s["p50_ms"],
                           "serve_p99_ms": s["p99_ms"],
                           "serve_goodput_rows_per_s": s["goodput"]},
            "attempted": attempted, "failed": failed, "checks": checks,
            "device": device, "layer_context": layer}
