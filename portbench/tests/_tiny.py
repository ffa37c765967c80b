"""Sizes a test run on the CPU can hold, per cell."""

TINY = {
    "churn_nb.train": {"assumed": {"train_rows": 20000}},
    "churn_markov.train": {"assumed": {"train_rows": 3000}},
    "churn_nb.serve": {"assumed": {"serve_train_rows": 4000},
                       "params": {"rate": 120, "pool_rows": 1000}},
    "churn_markov.serve": {"assumed": {"serve_train_rows": 2000},
                           "params": {"rate": 120, "pool_rows": 1000}},
}
SECONDS = 1.5
SEED = 2 ** 31 + 101


def run_tiny(name, trace=False, seed=SEED, extra=None):
    """One run of ``name`` on the CPU at its tiny size, past the look for
    a card."""
    import time

    import torch

    import run
    ov = {k: dict(v) for k, v in TINY[name].items()}
    for k, v in (extra or {}).items():
        ov[k] = dict(ov.get(k, {}), **v)
    return run.run_cell(name, seed, SECONDS, trace, torch.device("cpu"),
                        time.perf_counter(), overrides=ov)
