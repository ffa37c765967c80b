"""The control of each cell: the plain reference put in the program's
place, computed a precision below the one the configuration states, and
judged by the same comparison as a run.  It has to come out not
correct; its readings set the upper end of each limit (PERF.md).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds S]

Training cells: the model text with the counts held in int16.  Serving
cells: the answers to the requests a window of ``--seconds`` at the
cell's rate sends (as many as a run compares), the float64 variant's
computed in float32 and the float32 variant's in bfloat16.  With
``--program`` (serving cells, on a card): the program's own float32
path in place of its float64 one, a whole run at the cell's rate whose
float64-pinned requests are sent to the float32 variant and judged as
float64 answers.  Prints one JSON line a seed with the compared numbers
and whether they pass.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import common, traffic  # noqa: E402


#: the precision a step below each serving variant's
BELOW = {"f64": "float32", "f32": "bfloat16"}


def control_answers(ref, scorer, pool, idx, variants, id_prefix):
    """The reference in the program's place: each variant's answers
    computed a precision below it (``BELOW``)."""
    idx = np.asarray(idx)
    v = np.asarray(variants)
    out = [None] * len(idx)
    for variant, dtype in BELOW.items():
        sel = np.nonzero(v == variant)[0]
        if len(sel):
            lines = ref.expected_outputs(scorer, pool, idx[sel], id_prefix,
                                         dtype)
            for k, line in zip(sel, lines):
                out[k] = {"output": line}
    return out


def readings(name: str, seed: int, seconds: float, overrides=None) -> dict:
    cell = common.load_cell(name)
    for key, sub in (overrides or {}).items():
        (cell["params"] if key == "params" else cell["config_file"][key]
         ).update(sub)
    cfg, p = cell["config_file"], cell["params"]
    gen = common.load_module(BENCH_DIR / "gen" / f"{cell['config']}.py")
    ref = common.load_module(BENCH_DIR / "refs" / f"{cell['config']}.py")
    if cell["driver"] == "batch_job":
        data = gen.make(seed, int(cfg["assumed"][p["rows_key"]]), 0)["train"]
        want, got = ref.model_lines(data), ref.control_model_lines(data)
        diff = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        checks = {"model_lines_differing": diff}
    else:
        n_pool = traffic.pool_size(p)
        data = gen.make(seed, int(cfg["assumed"][p["rows_key"]]), n_pool)
        _, rows, variants = traffic.schedule(p, seconds, seed, n_pool)
        scorer = ref.Scorer(data["train"])
        answers = control_answers(ref, scorer, data["pool"], rows, variants,
                                  p["id_prefix"])
        checks = ref.judge_serve(answers, np.asarray(rows), variants, scorer,
                                 data["pool"], p["id_prefix"])
    passes = all(v <= ref.LIMITS[k] for k, v in checks.items())
    return {"workload": name, "seed": seed, "checks": checks,
            "correct": passes}


#: the program's own lower-precision path, switched on for the float64
#: variant's requests
PROGRAM_CONTROL = {"params": {"send_variant": {"f64": "f32"}}}


def program_readings(name: str, seed: int, seconds: float, device,
                     overrides=None) -> dict:
    import time

    import run
    ov = dict(overrides or {})
    ov["params"] = dict(ov.get("params", {}), **PROGRAM_CONTROL["params"])
    res = run.run_cell(name, seed, seconds, False, device,
                       time.perf_counter(), overrides=ov)
    return {"workload": name, "seed": seed, "control": "program float32",
            "checks": {k: v["value"] for k, v in res["checks"].items()},
            "correct": res["correct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float,
                    default=common.benchmark_spec()["run_seconds"])
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    device = None
    if args.program:
        common.cache_environment()
        import torch
        if not torch.cuda.is_available():
            common.log("--program needs a CUDA card")
            return 2
        device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        out = (program_readings(args.workload, int(s), args.seconds, device)
               if args.program
               else readings(args.workload, int(s), args.seconds))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
