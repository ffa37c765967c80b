"""K1's share of its roofline: the least time the card needs for a
launch's bytes at the HBM peak (``harness/peaks.py``) over K1's device
time a launch.

The bytes are the benchmark's count, from the cell's shapes
(``count_bytes``): each row's binned feature codes and its class, one
byte each (the least width they fit), read once, and the class x
feature x bin table of int32 counts, written once a launch.  The
launches are the program's own counter (``program_counters``
``k1_launches``).  The profiler drops some kernel events, so the time a
launch is the mean over the events it kept, and the bytes a launch the
mean over all launches."""

from harness.peaks import least_seconds


def count_bytes(ctx, launches: int) -> float:
    sizes = ctx.config["sizes"]
    rows = ctx.facts["rows_per_job"] * ctx.facts["jobs"]
    binned = [b for b in sizes["bins_per_feature"] if b > 0]
    table = sizes["classes"] * sum(binned) * 4
    return rows * (len(binned) + 1) + launches * table


def read(ctx):
    launches = ctx.facts.get("counters", {}).get("k1_launches", 0)
    ev = [d for _, t, d in ctx.device.kernels("histogram_kernel")
          if ctx.lo_ns <= t < ctx.hi_ns]
    if not launches or not ev:
        return None
    per_launch_s = least_seconds(count_bytes(ctx, launches) / launches)
    return 100.0 * per_launch_s / (sum(ev) / len(ev) / 1e9)
