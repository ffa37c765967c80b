"""K3's share of its roofline over the traced kNN jobs: the least time
the card needs for a distance job's selection at the peaks of
``harness/peaks.py``, over the device time of that job's ``topk.cu``
launches (the operand layout, K3 and its merge K3m, summed).

The work is the benchmark's count, from the cell's shapes (``work``),
so it reads the same however the program splits it between K3 and K3m:
per pair of a test and a training row, 2 F float32 operations (the
squared difference's expansion, one multiply-add a feature: the
kernel's own bound, PERF.md's kernel table); the bytes are each
operand's F float32 columns read once and k int64 keys written a test
row.  The jobs are the cell's traced pipelines
(``facts["job_spans_ns"]``); a job in which the profiler kept no K3
event is left out.  None where no K3 launch was counted
(``program_counters`` ``k3_launches``) or none was traced."""

from harness.peaks import least_seconds

KERNELS = ("layout_kernel", "topk_kernel", "merge_kernel")


def work(F: int, nq: int, nt: int, k: int):
    """``(operations, bytes)`` of one distance job's selection."""
    return 2 * F * nq * nt, 4 * F * (nq + nt) + 8 * k * nq


def _ours(name: str) -> bool:
    return any(k in name for k in KERNELS) and "at::" not in name


def read(ctx):
    if not ctx.facts.get("counters", {}).get("k3_launches"):
        return None
    sizes, assumed = ctx.config["sizes"], ctx.config["assumed"]
    ops, nbytes = work(sizes["features"], assumed["test_rows"],
                       assumed["train_rows"], sizes["k"])
    least = busy = 0.0
    for a, b in ctx.facts.get("job_spans_ns") or []:
        ev = [(n, d) for n, t, d in ctx.device.events
              if a <= t < b and _ours(n)]
        if not any("topk_kernel" in n for n, _ in ev):
            continue
        least += least_seconds(nbytes, ops)
        busy += sum(d for _, d in ev) / 1e9
    return 100.0 * least / busy if busy > 0 else None
