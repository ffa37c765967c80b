"""The readers of the batch job's host spans (``ingest.parse_share``,
``ingest.wait_share``, ``job.plumbing_share``, ``host.gc_share``) on a
``LayerContext`` built from hand-made spans: what each counts inside the
traced jobs, the union over threads, the window, and None where the run
holds nothing to read."""

import pytest
import torch

from avenir_tpu_torch.core.obs import Span
from harness import common
from harness.devtrace import DeviceTrace
from harness.layer import LayerContext

#: two traced jobs, [0, 100) and [200, 300), in a window [0, 400)
JOBS = [(0, 100), (200, 300)]
WALL = 200


def _span(name, a, b, tid=1):
    return Span(name, id((name, a, b, tid)), None, tid, f"t{tid}", a, b - a,
                {})


def _ctx(spans, jobs=JOBS, lo=0, hi=400):
    return LayerContext(spans, DeviceTrace(torch.device("cpu")), lo, hi,
                        {"job_spans_ns": list(jobs)}, {})


def _read(metric, ctx):
    reader = common.load_module(
        common.BENCH_DIR / "layer_metrics" / f"{metric}.py")
    return reader.read(ctx)


def test_parse_share_counts_parallel_threads_once():
    spans = [_span("ingest.parse", 10, 50, tid=1),
             _span("ingest.parse", 30, 70, tid=2),     # overlaps: once
             _span("ingest.parse", 210, 230, tid=1)]
    assert _read("ingest.parse_share", _ctx(spans)) == pytest.approx(
        (60 + 20) / WALL)


def test_shares_count_only_the_traced_jobs():
    spans = [_span("ingest.parse", 120, 180),          # between the jobs
             _span("ingest.parse", 90, 110),           # straddles job 0's end
             _span("ingest.parse", 350, 390),          # after the last job
             _span("ingest.parse", 500, 600)]          # past the window
    ctx = _ctx(spans)
    assert len(ctx.spans) == 3
    assert _read("ingest.parse_share", ctx) == pytest.approx(10 / WALL)


def test_wait_share_sums_and_allows_a_job_without_waits():
    spans = [_span("ingest.wait", 10, 20), _span("ingest.wait", 40, 70)]
    assert _read("ingest.wait_share", _ctx(spans)) == pytest.approx(
        40 / WALL)


def test_plumbing_share_is_the_union_of_its_spans():
    spans = [_span("cli.prepare", 0, 10), _span("ingest.read", 10, 15),
             _span("ingest.split", 15, 18), _span("model.lines", 90, 95),
             _span("phase:emit", 94, 100),              # overlaps: once
             _span("cli.prepare", 200, 212),
             _span("ingest.parse", 20, 90),             # not plumbing
             _span("job:BayesianDistribution", 1, 100)]
    want = (10 + 5 + 3 + 10) + 12
    assert _read("job.plumbing_share", _ctx(spans)) == pytest.approx(
        want / WALL)


def test_gc_share_reads_host_gc_spans():
    spans = [_span("host.gc", 50, 52), _span("host.gc", 250, 260, tid=3)]
    assert _read("host.gc_share", _ctx(spans)) == pytest.approx(12 / WALL)


def test_gc_share_is_zero_where_no_pass_ran():
    # the program records its passes (it records cli.prepare), none ran
    # inside a job
    spans = [_span("cli.prepare", 0, 10), _span("host.gc", 150, 160)]
    assert _read("host.gc_share", _ctx(spans)) == 0.0
    assert _read("host.gc_share", _ctx(spans[:1])) == 0.0


@pytest.mark.parametrize("metric", ["ingest.parse_share", "ingest.wait_share",
                                    "job.plumbing_share", "host.gc_share"])
def test_none_without_spans_or_jobs(metric):
    # a program that records none of the spans (an older one) reads None
    other = [_span("phase:train", 0, 100), _span("ingest.fold", 5, 6),
             _span("ingest.h2d", 4, 5)]
    assert _read(metric, _ctx(other)) is None
    full = [_span(n, 0, 100) for n in
            ("ingest.parse", "ingest.wait", "cli.prepare", "host.gc")]
    assert _read(metric, _ctx(full, jobs=[])) is None
    got = _read(metric, _ctx(full))
    assert 0.0 <= got <= 1.0
