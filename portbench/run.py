"""The benchmark of avenir_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell (``portbench/workloads/<cell>.json``) on one card: it
generates the cell's inputs from the seed, sets the program up and warms
it (``setup_s``), measures for ``--seconds``, checks what the measured
path produced against the plain reference (``portbench/refs``), and
prints one JSON line last on standard output.  With ``--trace 0`` that
line carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read by ``portbench/layer_metrics/<metric>.py``
from the program's spans and counters and the device's trace.  Which
metrics a cell reports is what ``BENCHMARK.json`` lists for it.

A run needs a CUDA card: without one (or with fewer than the cell asks
for) it exits non-zero and prints no result.  So does a run after which
a JAX module, or the JAX package the port came from, is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))
if str(BENCH_DIR.parent) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR.parent))

from harness import common  # noqa: E402


class RunContext:
    """What a driver is given: the cell, the run's arguments, the device
    and the time the process started."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell = cell
        self.config = cell["config_file"]
        self.params = cell.get("params", {})
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.work = common.work_dir(cell["name"])

    def module(self, kind: str):
        """``gen`` or ``refs`` module of the cell's configuration."""
        return common.load_module(BENCH_DIR / kind / f"{self.cell['config']}.py",
                                  f"portbench_{kind}_{self.cell['config']}")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, spec: dict = None,
             overrides: dict = None) -> dict:
    """One run of cell ``name`` on ``device`` (a ``torch.device``), past
    the look for a card: returns the result object.  ``overrides``
    (tests only) replaces keys of the cell's ``params`` and of its
    configuration's ``assumed`` sizes."""
    spec = spec or common.benchmark_spec()
    cell = common.load_cell(name)
    for key, sub in ((overrides or {}).items()):
        target = cell["params"] if key == "params" else \
            cell["config_file"][key]
        target.update(sub)
    wanted = common.metrics_for(name, spec)
    ctx = RunContext(cell, seed, seconds, trace, device, t_start)
    shutil.rmtree(ctx.work, ignore_errors=True)
    ctx.work.mkdir(parents=True)
    driver = common.load_module(BENCH_DIR / "drivers" / f"{cell['driver']}.py")
    try:
        out = driver.run(ctx)
    finally:
        gc.collect()
        shutil.rmtree(ctx.work, ignore_errors=True)
    limits = ctx.module("refs").LIMITS
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in out["checks"].items()}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    metrics = {}
    breakdown = None
    if trace:
        lc = out["layer_context"]
        for m in wanted["per_layer"]:
            reader = common.load_module(
                BENCH_DIR / "layer_metrics" / f"{m['name']}.py")
            v = reader.read(lc)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"]["busy_s"] = lc.busy_s
        out["device"]["window_s"] = lc.window_s
        breakdown = lc.breakdown
    else:
        for m in wanted["end_to_end"]:
            v = out["end_to_end"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": common.finite(v),
                                      "unit": m["unit"]}
    return {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"], "breakdown": breakdown,
            "checks": checks}


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    common.cache_environment()
    cell = common.load_cell(args.workload)
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"cell {args.workload} needs {chips} CUDA card(s); "
                   f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    common.log(f"card: {common.card_power()}; torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}")
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    bad = common.forbidden_loaded()
    if bad:
        common.log(f"modules of JAX or of the JAX package were loaded: "
                   f"{', '.join(bad)}")
        return 3
    for line in common.check_lines(res["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(common.result_line(res["correct"], res["attempted"], res["failed"],
                             res["metrics"], res["device"], res["checks"],
                             res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
