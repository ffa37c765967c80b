"""K1 and K2, the histogram kernels, measured on a CUDA card beyond what
``chip_smoke.py`` holds::

    python -m avenir_tpu_torch.histogram_probe [--calls] [--routes]

``--calls`` times the wrappers at the shapes of ``chip_smoke.py``'s K1/K2
rows, on seeded inputs of those shapes and dtypes, each held exact against
its plain version: the call time (``timing.time_ms``: 200 back-to-back
calls after 0.2 s of calls), the kernel's own device time
(``timing.kernel_device_ms``), and both again at one row.  It calls only
the wrappers' public functions, so copied with ``timing.py`` into another
checkout's ``avenir_tpu_torch/`` and run from that checkout's root, it
times that checkout's kernels by the same method: run on a change and on
its parent in one call (parent, change, change, parent), the two compare.

``--routes`` is the measurement behind ``ops.histogram.CLUSTER``: K1 on a
256 KB and a 1,800 KB table (262,144 int32 rows of 64 features, 8 classes,
128 and 900 bins) with the table forced into a cluster of 2, 4 or 8 blocks
(where its slices fit) and into global memory, each held exact against the
plain version, by device time.  Launched through the library, so no launch
is counted.

With neither flag, both run.  Prints the card's name and power limit, then
one JSON object a line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from .ops import histogram
from .timing import kernel_device_ms, time_ms

KERNEL = "histogram_kernel"
CHURN_WIDTHS = (1, 200, 100, 2, 4, 1)     # the churn trainer's K2 widths
WIDE_WIDTHS = tuple(1 + (7 * f) % 40 for f in range(32))

# (kernel, case, n, F, C, B, dtype, lowest code, highest + 1, widths,
#  mask): chip_smoke.py's K1/K2 rows, the main-path chunks at their shape
CASES = [
    ("K1", "main-path cold chunk shape", 131_072, 6, 2, 16, torch.int8, -1,
     16, None, False),
    ("K2", "main-path warm chunk shape", 131_072, 6, 2, 16, torch.int32,
     -40, 16 * 200, CHURN_WIDTHS, False),
    ("K1", "churn", 1_600_000, 6, 2, 16, torch.int8, -1, 18, None, True),
    ("K1", "hot cell", 1_600_000, 6, 2, 16, torch.int8, 8, 9, None, False),
    ("K1", "wide", 2_000_000, 32, 8, 32, torch.int32, -1, 34, None, True),
    ("K1", "256 KB table", 1 << 18, 64, 8, 128, torch.int32, -1, 130, None,
     True),
    ("K1", "2 MB table", 1 << 18, 64, 8, 1024, torch.int32, -1, 1026, None,
     True),
    ("K2", "churn", 1_600_000, 6, 2, 16, torch.int32, -40, 16 * 200,
     CHURN_WIDTHS, True),
    ("K2", "wide", 2_000_000, 32, 8, 32, torch.int32, -400, 1300,
     WIDE_WIDTHS, True),
]


def _inputs(n, F, C, dtype, lo, hi, masked, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(lo, hi, (n, F), generator=g, device="cuda").to(dtype)
    if hi - lo == 1:                        # the hot cell: one class too
        y = torch.full((n,), C - 1, dtype=dtype, device="cuda")
    else:
        y = torch.randint(-1 if masked else 0, C + 1 if masked else C, (n,),
                          generator=g, device="cuda").to(dtype)
    mask = torch.rand(n, generator=g, device="cuda") < 0.9 if masked else None
    return x, y, mask


def calls() -> None:
    for seed, (kid, case, n, F, C, B, dtype, lo, hi, widths,
               masked) in enumerate(CASES):
        x, y, mask = _inputs(n, F, C, dtype, lo, hi, masked, seed)

        def call(x, y, mask, out):
            if widths is None:
                return histogram.wide_feature_class_counts(
                    x, y, C, B, mask=mask, out=out)
            return histogram.wide_feature_class_counts_rawbin(
                x, y, C, B, widths, mask=mask, out=out)

        want = (histogram.plain_feature_class_counts(x, y, C, B, mask)
                if widths is None else
                histogram.plain_feature_class_counts_rawbin(
                    x, y, C, B, widths, mask))
        if not torch.equal(call(x, y, mask, None), want):
            raise AssertionError(f"{kid} at {case} differs from its plain "
                                 f"version")
        acc = torch.zeros((C, F, B), dtype=torch.int32, device="cuda")
        one = (x[:1], y[:1], None if mask is None else mask[:1])
        row = {"probe": "calls", "kernel": kid, "case": case, "n": n, "F": F,
               "C": C, "B": B, "dtype": str(dtype).replace("torch.", ""),
               "mask": masked,
               "ms": time_ms(lambda: call(x, y, mask, acc), 200, 0.2),
               "device_ms": kernel_device_ms(lambda: call(x, y, mask, acc),
                                             50, KERNEL),
               "floor_ms": time_ms(lambda: call(*one, acc), 200, 0.2),
               "floor_device_ms": kernel_device_ms(lambda: call(*one, acc),
                                                   50, KERNEL)}
        print(json.dumps(row), flush=True)
        del x, y, mask, want, acc, one
        torch.cuda.empty_cache()


def routes() -> None:
    info = histogram._device_info(0)
    lib = histogram._library()
    n, F, C = 1 << 18, 64, 8
    for B, seed in ((128, 3), (900, 7)):
        x, y, _ = _inputs(n, F, C, torch.int32, -1, B + 2, True, seed)
        want = histogram.plain_feature_class_counts(x, y, C, B)
        auto = histogram.histogram_plan(n, F, C, B, 4, *info)
        for route, blocks in ((1, 2), (1, 4), (1, 8), (2, 1)):
            try:
                p = histogram.histogram_plan(n, F, C, B, 4, *info,
                                             route=route, cluster=blocks)
            except ValueError:              # its slices do not fit
                continue
            plan = histogram.plan_struct(n, F, C, B, 4, p)
            out = torch.zeros((C, F, B), dtype=torch.int32, device="cuda")

            def launch():
                histogram._raise_on(lib.avenir_histogram(
                    x.data_ptr(), y.data_ptr(), 4, None, None,
                    out.data_ptr(), ctypes.addressof(plan),
                    torch._C._cuda_getCurrentRawStream(0)), "launch")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"K1 with {C * F * B} cells in "
                                     f"{blocks} blocks differs from its "
                                     f"plain version")
            print(json.dumps({
                "probe": "routes", "table_kb": C * F * B * 4 // 1024,
                "route": histogram.ROUTES[p.route], "cluster": p.cluster,
                "planned": (p.route, p.cluster) == (auto.route, auto.cluster),
                "device_ms": kernel_device_ms(launch, 20, KERNEL)}),
                flush=True)
        del x, y, want
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", action="store_true")
    ap.add_argument("--routes", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("histogram_probe needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}; package: "
          f"{os.path.dirname(os.path.abspath(histogram.__file__))}",
          flush=True)
    everything = not (args.calls or args.routes)
    if args.calls or everything:
        calls()
    if args.routes or everything:
        routes()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
