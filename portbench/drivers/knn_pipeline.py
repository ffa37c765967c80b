"""Two-job kNN pipelines of the program's command line, back to back.

Set-up generates the cell's training and test rows from the seed
(``gen/<config>``) and writes them as ``tr-00000`` and ``te-00000`` of
one input directory, as ``resource/knn_classify/run.sh`` lays them out;
writes the configuration's files; and runs one whole pipeline, cold, to
build and warm what it uses.  A pipeline is the distance job on the
input directory, then the vote job on the distance job's output, each
into its own directory.  The window then runs whole pipelines until
``--seconds`` is up; the last one that starts inside it runs to its end.

``batch_rows_per_s``: training and test rows of all window pipelines
over the time from the first pipeline's start to the last one's end.
``correct``: after the window, each window pipeline's pair lines and
prediction lines, with the vote job's validation counters, against the
reference (``refs/<config>``); a pipeline whose files are byte-equal to
one already held to the reference takes that one's numbers.

Cell parameters (``params`` of the workload file): ``distance_job`` and
``vote_job`` (class names on the command line), ``distance_properties``
and ``vote_properties`` (the configuration's files they read),
``defines`` (extra ``-D`` settings), ``program_counters`` (``name``:
``module:attribute`` integers of the program read around the window).
The sizes are the configuration's: ``assumed`` ``train_rows`` and
``test_rows``, ``sizes`` ``k`` and ``scale``.
"""

from __future__ import annotations

import gc
import hashlib
import time

from harness import common
from harness.devtrace import TRACE_SECONDS, DeviceTrace
from harness.layer import LayerContext
from harness.setup import run_job, write_config_files

# batch_job's tracer buffer and its reading of program_counters
_batch = common.load_module(common.BENCH_DIR / "drivers" / "batch_job.py")
TRACE_SPANS = _batch.TRACE_SPANS
_counters = _batch._counters


def _job_counters(stderr: str) -> dict:
    """``group.name``: value of the counters a job printed."""
    out = {}
    for line in stderr.splitlines():
        f = line.split("\t")
        if len(f) == 3 and f[2].lstrip("-").isdigit():
            out[f"{f[0]}.{f[1]}"] = int(f[2])
    return out


def run(ctx) -> dict:
    params, cfg = ctx.params, ctx.config
    n_train = int(cfg["assumed"]["train_rows"])
    n_test = int(cfg["assumed"]["test_rows"])
    k, scale = int(cfg["sizes"]["k"]), int(cfg["sizes"]["scale"])
    gen, ref = ctx.module("gen"), ctx.module("refs")
    data = gen.make(ctx.seed, n_train, n_test)
    train, test = data["train"], data["pool"]
    in_dir = ctx.work / "in"
    in_dir.mkdir(parents=True)
    (in_dir / "tr-00000").write_bytes(gen.csv_bytes(train, b"T"))
    (in_dir / "te-00000").write_bytes(gen.csv_bytes(test, b"Q"))
    paths = write_config_files(cfg, ctx.work)
    dev = str(ctx.device)
    defines = dict(params.get("defines", {}))
    if ctx.trace:
        defines.update({"obs.trace.enable": "true",
                        "obs.trace.buffer.spans": str(TRACE_SPANS)})

    def pipeline(tag: str) -> dict:
        """One pipeline; the counters each job printed."""
        sim, pred = ctx.work / f"sim{tag}", ctx.work / f"pred{tag}"
        a = run_job(params["distance_job"],
                    paths[params["distance_properties"]], in_dir, sim, dev,
                    defines)
        b = run_job(params["vote_job"], paths[params["vote_properties"]],
                    sim, pred, dev, defines)
        return {**_job_counters(a), **_job_counters(b)}

    # set-up: one whole cold pipeline builds the native parser and K3
    pipeline("warm")
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
    traced = None                     # (pipelines, end ns, counters)
    spans_ns = []
    job_counters = []
    failed = 0
    t0 = time.perf_counter_ns()
    end = t0 + int(ctx.seconds * 1e9)
    n = 0
    while time.perf_counter_ns() < end:
        a = time.perf_counter_ns()
        try:
            job_counters.append(pipeline(str(n)))
        except RuntimeError as e:
            common.log(f"pipeline {n} failed: {e}")
            job_counters.append(None)
            failed += 1
        spans_ns.append((a, time.perf_counter_ns()))
        n += 1
        if trace.active and spans_ns[-1][1] - t0 >= TRACE_SECONDS * 1e9:
            # the trace holds the whole pipelines of its first seconds
            traced = (n, trace.stop(), _counters(params))
    t1 = spans_ns[-1][1]
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.synchronize(ctx.device)
    if trace.active or traced is None:
        traced = (n, trace.stop() or t1, _counters(params))
    device = common.card_description(ctx.device)

    layer = None
    rows = n_train + n_test
    if ctx.trace:
        from avenir_tpu_torch.core import obs
        spans = obs.get_tracer().spans()
        jobs, hi, after = traced
        facts = {"rows_per_job": rows, "jobs": jobs,
                 "job_spans_ns": spans_ns[:jobs],
                 "counters": {c: after[c] - before.get(c, 0) for c in after}}
        layer = LayerContext(spans, trace, t0, hi, facts, cfg)
        obs.get_tracer().clear()
    gc.collect()
    if ctx.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the peak is read
    r0 = time.perf_counter()
    dist, idx = ref.nearest(train, test, k, scale, ctx.device)
    common.log(f"reference nearest: {time.perf_counter() - r0:.2f} s")
    worst = {name: 0 for name in ref.LIMITS}
    held = {}
    for j in range(n):
        try:
            pairs = (ctx.work / f"sim{j}" / "part-r-00000").read_bytes()
            preds = (ctx.work / f"pred{j}" / "part-r-00000").read_bytes()
        except OSError:
            pairs = preds = b""
        validation = {c.split(".", 1)[1]: v
                      for c, v in (job_counters[j] or {}).items()
                      if c.startswith("Validation.")}
        key = hashlib.sha1(pairs + b"\0" + preds + b"\0" + repr(
            sorted(validation.items())).encode()).hexdigest()
        if key not in held:
            lines = pairs.decode().splitlines()
            got = ref.check_pairs(lines, train, test, dist, idx, scale)
            got["predictions_differing"] = ref.check_predictions(
                lines, preds.decode().splitlines(), validation, k)
            held[key] = got
        for name, v in held[key].items():
            worst[name] = max(worst[name], v)
    engines = sorted({(c.get("Distance.Fused engine calls"),
                       c.get("Distance.Re-resolved rows"))
                      for c in job_counters if c is not None})
    jobs_ok = n - failed
    took = sorted((b - a) / 1e9 for a, b in spans_ns)
    common.log(f"{n} pipelines, {failed} failed, {len(held)} distinct "
               f"outputs; (fused engine calls, re-resolved rows) "
               f"{engines}; a pipeline took {took[0]:.4f} s at least, "
               f"{took[len(took) // 2]:.4f} s median, {took[-1]:.4f} s at "
               f"most")
    return {"setup_s": setup_s,
            "end_to_end": {"setup_s": setup_s,
                           "batch_rows_per_s": jobs_ok * rows / ((t1 - t0) / 1e9)},
            "attempted": n, "failed": failed,
            "checks": worst,
            "device": device, "layer_context": layer}
