"""The control of each cell comes out not correct: the plain reference
in the program's place, a precision below the configuration's (int16
counts for training; float32 for the float64 variant and bfloat16 for
the float32 one when serving), judged as a run is judged; and the
program's own float32 path answering the float64 variant's requests.

The reference's control at the cells' own sizes, on three seeds each;
the program's at a size the CPU holds, and at the cells' own sizes on the
card (``-m card``)."""

import pytest

from _tiny import SECONDS, TINY
from harness import common

import control

CELLS = [w["name"] for w in common.benchmark_spec()["workloads"]]
#: the serving workloads, listed in BENCHMARK.json or not yet
SERVING = sorted(p.name[:-len(".json")] for p in
                 (common.BENCH_DIR / "workloads").glob("*.serve.json"))


@pytest.mark.parametrize("name", CELLS + SERVING)
def test_reference_control_fails_at_cell_size(name):
    """NumPy (and PyTorch on the CPU): no card needed at the cells' own
    sizes and rates, over a window of ``run_seconds``."""
    seconds = common.benchmark_spec()["run_seconds"]
    for seed in (2 ** 31 + 311, 2 ** 31 + 312, 2 ** 31 + 313):
        out = control.readings(name, seed, seconds)
        print(out)
        assert not out["correct"], out


def test_program_control_fails_on_markov(tmp_env):
    import torch
    out = control.program_readings("churn_markov.serve", 5, SECONDS,
                                   torch.device("cpu"),
                                   TINY["churn_markov.serve"])
    assert not out["correct"] and out["checks"]["f64_mismatch"] > 0, out


@pytest.mark.card
@pytest.mark.parametrize("name", SERVING)
def test_program_control_fails_at_cell_size(name, card, tmp_env):
    seconds = common.benchmark_spec()["run_seconds"]
    for seed in (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303):
        out = control.program_readings(name, seed, seconds, card)
        print(out)
        assert not out["correct"] and out["checks"]["f64_mismatch"] > 0, out
