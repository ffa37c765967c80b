"""The sweep that fixes a serving cell's rate: one set-up of the cell's
server, then one open-loop window at each rate, lowest first.

    python3 portbench/sweep.py --workload <serve cell> --seed <n> --seconds <s> --rates 500,1000,2000

For each rate it prints the requests, failures, p50 and p99 (from each
request's due time), the requests still unanswered when the window
closed (a growing backlog) and the goodput; and on standard error every
garbage collection of 10 ms or more in the server's process.  The knee
is the highest rate whose p99 stays within the deployment's
``serve.slo.p99.ms`` with no backlog growing; the cell runs at four
fifths of it.  It needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--drain", type=float, default=20.0)
    args = ap.parse_args(argv)
    # every garbage collection of 10 ms or more: the pauses that set the
    # serving tails (PERF.md)
    import gc
    t = {}

    def cb(phase, info):
        if phase == "start":
            t["t"] = time.perf_counter()
        elif time.perf_counter() - t.get("t", 0) > 0.01:
            common.log(f"gc gen {info['generation']}: "
                       f"{(time.perf_counter() - t['t']) * 1e3:.1f} ms")
    gc.callbacks.append(cb)
    common.cache_environment()
    import torch
    if not torch.cuda.is_available():
        common.log("the sweep needs a CUDA card")
        return 2
    import run
    cell = common.load_cell(args.workload)
    ctx = run.RunContext(cell, args.seed, args.seconds, False,
                         torch.device("cuda", 0), T_START)
    shutil.rmtree(ctx.work, ignore_errors=True)
    ctx.work.mkdir(parents=True)
    driver = common.load_module(BENCH_DIR / "drivers" / f"{cell['driver']}.py")
    common.log(f"card: {common.card_power()}")
    server = driver.Server(ctx)
    common.log(f"set-up {time.perf_counter() - T_START:.3f} s")
    slo_ms = driver.goodput_ms(ctx)
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            win = driver.open_loop(server, rate, args.seconds,
                                   args.seed + i, drain_s=args.drain)
            s = driver.summarize(win, args.seconds, slo_ms)
            row = {k: v for k, v in s.items() if k != "answers"}
            row["rate"] = rate
            print(json.dumps(row), flush=True)
    finally:
        server.stop()
        shutil.rmtree(ctx.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
