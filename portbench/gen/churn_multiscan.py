"""The rows of the shared-scan churn workflow: ``churn_nb``'s telecom-churn
rows (``gen/churn_nb.py``, loaded from there, not copied), so that this
cell and ``churn_nb.train`` read the same file for the same seed.
``teleComChurnBinned.json`` reads the same eight columns; it declares
the plan vocabulary and bins ``network`` by 2 up to its clip of 12."""

from __future__ import annotations

from pathlib import Path

from harness.common import load_module

_NB = load_module(Path(__file__).resolve().parent / "churn_nb.py",
                  "portbench_gen_churn_nb")

make = _NB.make
csv_bytes = _NB.csv_bytes
