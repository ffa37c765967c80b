"""Shared-scan workflows of the program's ``multi`` command, back to back.

Set-up generates the cell's input file from the seed (``gen/<config>``),
writes the configuration's files (the schema and the ``multi.jobs``
manifest) and runs one whole ``multi`` command, cold, to build and warm
what its jobs use.  The window then runs whole ``multi`` commands on the
same input through ``avenir_tpu_torch.cli.main`` in process, each into
its own output base (one directory a job of the manifest), until
``--seconds`` is up; the last one that starts inside the window runs to
its end.

``batch_rows_per_s``: input rows of every window command over the time
from the first one's start to the last one's end, each scan's rows
counted once however many jobs it feeds.  ``correct``: every window
command's job outputs against the reference's (``refs/<config>.outputs``,
``lines_differing``) in ``output_lines_differing``, the worst command's;
and ``standalone_reruns``, the jobs the window ran outside the shared
scan, from the program counter of that name.

Cell parameters (``params`` of the workload file): ``manifest`` (the
configuration's file that lists the jobs), ``rows_key`` (the key of
``assumed`` that sizes the input), ``defines`` (extra ``-D`` settings),
``program_counters`` (``name``: ``module:attribute`` integers of the
program read around the window; ``standalone_reruns`` among them).  A
program without one of those counters fails the run before set-up.
The per-layer readers get the facts ``batch_job`` gives (``rows_per_job``,
``jobs``, ``job_spans_ns``, ``counters``).
"""

from __future__ import annotations

import gc
import importlib
import time

from harness import common
from harness.devtrace import TRACE_SECONDS, DeviceTrace
from harness.layer import LayerContext
from harness.setup import run_job, write_config_files, write_rows

# spans enough for a traced window of a few hundred commands
TRACE_SPANS = 1 << 20


def _counters(params: dict) -> dict:
    out = {}
    for name, where in params.get("program_counters", {}).items():
        mod, attr = where.split(":")
        out[name] = int(getattr(importlib.import_module(mod), attr))
    return out


def _outputs(base, jobs) -> dict:
    out = {}
    for jid in jobs:
        try:
            out[jid] = (base / jid / "part-r-00000").read_text().splitlines()
        except OSError:
            out[jid] = []
    return out


def run(ctx) -> dict:
    params, cfg = ctx.params, ctx.config
    _counters(params)                 # a program without them fails now
    rows = int(cfg["assumed"][params["rows_key"]])
    gen, ref = ctx.module("gen"), ctx.module("refs")
    data = gen.make(ctx.seed, rows, 0)["train"]
    in_dir = write_rows(ctx.work / "in", gen.csv_bytes(data, b"C"))
    paths = write_config_files(cfg, ctx.work)
    manifest = paths[params["manifest"]]
    jobs = [j.strip() for j in
            cfg["files"][params["manifest"]]["multi.jobs"].split(",")]
    dev = str(ctx.device)
    defines = dict(params.get("defines", {}))
    if ctx.trace:
        defines.update({"obs.trace.enable": "true",
                        "obs.trace.buffer.spans": str(TRACE_SPANS)})

    # set-up: one whole cold command builds the native parsers and kernels
    run_job("multi", manifest, in_dir, ctx.work / "warm", dev, defines)
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    trace = DeviceTrace(ctx.device)
    if ctx.trace:
        from avenir_tpu_torch.core import obs
        obs.get_tracer().clear()
        trace.start()
    setup_s = time.perf_counter() - ctx.t_start

    before = _counters(params)
    traced = None                     # (commands, end ns, counters)
    spans_ns = []
    failed = 0
    t0 = time.perf_counter_ns()
    end = t0 + int(ctx.seconds * 1e9)
    k = 0
    while time.perf_counter_ns() < end:
        a = time.perf_counter_ns()
        try:
            run_job("multi", manifest, in_dir, ctx.work / f"out{k}", dev,
                    defines)
        except RuntimeError as e:
            common.log(f"command {k} failed: {e}")
            failed += 1
        spans_ns.append((a, time.perf_counter_ns()))
        k += 1
        if trace.active and spans_ns[-1][1] - t0 >= TRACE_SECONDS * 1e9:
            # the trace holds the whole commands of its first seconds
            traced = (k, trace.stop(), _counters(params))
    t1 = spans_ns[-1][1]
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.synchronize(ctx.device)
    if trace.active or traced is None:
        traced = (k, trace.stop() or t1, _counters(params))
    after = _counters(params)
    device = common.card_description(ctx.device)

    layer = None
    if ctx.trace:
        from avenir_tpu_torch.core import obs
        spans = obs.get_tracer().spans()
        n_traced, hi, at_trace = traced
        facts = {"rows_per_job": rows, "jobs": n_traced,
                 "job_spans_ns": spans_ns[:n_traced],
                 "counters": {n: at_trace[n] - before.get(n, 0)
                              for n in at_trace}}
        layer = LayerContext(spans, trace, t0, hi, facts, cfg)
        obs.get_tracer().clear()
    gc.collect()
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the peak is read
    want = ref.outputs(data)
    worst = max(ref.lines_differing(_outputs(ctx.work / f"out{j}", jobs),
                                    want) for j in range(k))
    took = sorted((b - a) / 1e9 for a, b in spans_ns)
    common.log(f"{k} commands, {failed} failed; one took {took[0]:.4f} s at "
               f"least, {took[len(took) // 2]:.4f} s median, "
               f"{took[-1]:.4f} s at most")
    return {"setup_s": setup_s,
            "end_to_end": {"setup_s": setup_s,
                           "batch_rows_per_s":
                               (k - failed) * rows / ((t1 - t0) / 1e9)},
            "attempted": k, "failed": failed,
            "checks": {"output_lines_differing": worst,
                       "standalone_reruns": (after["standalone_reruns"]
                                             - before["standalone_reruns"])},
            "device": device, "layer_context": layer}
