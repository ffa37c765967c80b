"""Batch jobs of the program's command line, back to back.

Set-up generates the cell's input file from the seed (``gen/<config>``),
writes the configuration's files and runs one whole job, cold, to build
and warm what the job uses.  The window then runs whole jobs on the same
input, each into its own output directory, until ``--seconds`` is up;
the last job that starts inside the window runs to its end.

``batch_rows_per_s``: input rows of all window jobs over the time from
the first job's start to the last one's end.  ``correct``: every window
job's model text against the reference's (``refs/<config>.model_lines``),
line by line.

Cell parameters (``params`` of the workload file): ``job`` (the class
name on the command line), ``properties`` (the configuration's file the
job reads), ``rows_key`` (the key of ``assumed`` that sizes the input),
``defines`` (extra ``-D`` settings), ``program_counters`` (``name``:
``module:attribute`` integers of the program read around the window).
"""

from __future__ import annotations

import gc
import importlib
import time

from harness import common
from harness.devtrace import TRACE_SECONDS, DeviceTrace
from harness.layer import LayerContext
from harness.setup import read_model, run_job, write_config_files, write_rows

# spans enough for a traced window of a few hundred jobs
TRACE_SPANS = 1 << 20


def _counters(params: dict) -> dict:
    out = {}
    for name, where in params.get("program_counters", {}).items():
        mod, attr = where.split(":")
        out[name] = int(getattr(importlib.import_module(mod), attr))
    return out


def run(ctx) -> dict:
    params, cfg = ctx.params, ctx.config
    rows = int(cfg["assumed"][params["rows_key"]])
    gen, ref = ctx.module("gen"), ctx.module("refs")
    data = gen.make(ctx.seed, rows, 0)["train"]
    in_dir = write_rows(ctx.work / "in", gen.csv_bytes(data, b"C"))
    paths = write_config_files(cfg, ctx.work)
    props = paths[params["properties"]]
    dev = str(ctx.device)
    defines = dict(params.get("defines", {}))
    if ctx.trace:
        defines.update({"obs.trace.enable": "true",
                        "obs.trace.buffer.spans": str(TRACE_SPANS)})

    # set-up: one whole cold job builds the native parser and the kernels
    run_job(params["job"], props, in_dir, ctx.work / "warm", dev, defines)
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
    traced = None                     # (jobs, end ns, counters) of the trace
    spans_ns = []
    failed = 0
    t0 = time.perf_counter_ns()
    end = t0 + int(ctx.seconds * 1e9)
    k = 0
    while time.perf_counter_ns() < end:
        a = time.perf_counter_ns()
        try:
            run_job(params["job"], props, in_dir, ctx.work / f"out{k}", dev,
                    defines)
        except RuntimeError as e:
            common.log(f"job {k} failed: {e}")
            failed += 1
        spans_ns.append((a, time.perf_counter_ns()))
        k += 1
        if trace.active and spans_ns[-1][1] - t0 >= TRACE_SECONDS * 1e9:
            # the trace holds the whole jobs of its first seconds
            traced = (k, trace.stop(), _counters(params))
    t1 = spans_ns[-1][1]
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.synchronize(ctx.device)
    if trace.active or traced is None:
        # a trace still running ends with the window (on the CPU there is
        # none, and the spans of the whole window are read)
        traced = (k, trace.stop() or t1, _counters(params))
    device = common.card_description(ctx.device)

    layer = None
    if ctx.trace:
        from avenir_tpu_torch.core import obs
        spans = obs.get_tracer().spans()
        jobs, hi, after = traced
        facts = {"rows_per_job": rows, "jobs": jobs,
                 "job_spans_ns": spans_ns[:jobs],
                 "counters": {n: after[n] - before.get(n, 0) for n in after}}
        layer = LayerContext(spans, trace, t0, hi, facts, cfg)
        obs.get_tracer().clear()
    gc.collect()
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the peak is read
    want = ref.model_lines(data)
    worst = 0
    for j in range(k):
        try:
            got = read_model(ctx.work / f"out{j}")
        except OSError:
            got = []
        diff = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        worst = max(worst, diff)
    jobs_ok = k - failed
    took = sorted((b - a) / 1e9 for a, b in spans_ns)
    common.log(f"{k} jobs, {failed} failed; a job took {took[0]:.4f} s at "
               f"least, {took[len(took) // 2]:.4f} s median, {took[-1]:.4f} s "
               f"at most")
    return {"setup_s": setup_s,
            "end_to_end": {"setup_s": setup_s,
                           "batch_rows_per_s": jobs_ok * rows / ((t1 - t0) / 1e9)},
            "attempted": k, "failed": failed,
            "checks": {"model_lines_differing": worst},
            "device": device, "layer_context": layer}
