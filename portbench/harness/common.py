"""What every cell shares: where things are, how a cell is found by its
name, the environment a run keeps its caches in, the card's description,
the check that nothing of JAX was loaded, and the result line.

A cell is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``) and
carries its traffic parameters.  The metrics a run reports are the ones
``BENCHMARK.json`` at the root of the checkout lists for the cell: the
end-to-end metrics with ``--trace 0`` and the per-layer metrics, each
read by ``layer_metrics/<metric>.py``, with ``--trace 1``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

#: top-level module names that no run may load: JAX and its companions,
#: and the JAX package that the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "avenir_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: Optional[str] = None):
    """Import one file of the benchmark by its path (metric readers carry
    dots in their names, so they are not importable by name)."""
    name = name or "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> dict:
    """The workload file of cell ``name`` with its configuration file
    merged in under ``config_file``."""
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no workload {name!r} ({path})")
    cell = load_json(path)
    cell["name"] = name
    cfg = BENCH_DIR / "configs" / f"{cell['config']}.json"
    cell["config_file"] = load_json(cfg)
    return cell


def benchmark_spec() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise SystemExit(f"portbench: {path} is missing")
    return load_json(path)


def _listed(metric: dict, cell: str, reported: List[str]) -> bool:
    wl = metric.get("workloads")
    if wl is not None:
        return cell in wl
    # a per-layer metric without a list goes wherever its end-to-end
    # metric is reported
    return metric.get("moves") in reported if "moves" in metric else True


def metrics_for(cell: str, spec: Optional[dict] = None) -> dict:
    """``{"end_to_end": [...], "per_layer": [...]}``: the metric entries of
    ``BENCHMARK.json`` that this cell reports."""
    spec = spec or benchmark_spec()
    e2e = [m for m in spec["end_to_end"] if _listed(m, cell, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in spec["per_layer"] if _listed(m, cell, names)]
    return {"end_to_end": e2e, "per_layer": layer}


def cache_environment() -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run in a checkout builds (the port's own nvcc and
    cc builds already go to ``avenir_tpu_torch/build/``)."""
    cache = ROOT / ".portbench_cache"
    env = {"TRITON_CACHE_DIR": str(cache / "triton"),
           "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
           # keep transformers-style libraries from loading JAX or Flax
           "USE_FLAX": "0", "USE_JAX": "0"}
    os.environ.update(env)
    # one BLAS and OpenMP thread (set before numpy and torch load): a
    # pool of spinning threads on a host shared with other work spreads
    # the host-bound cells' runs
    for k in THREAD_VARS:
        os.environ.setdefault(k, "1")
    return env


THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def work_dir(cell: str) -> Path:
    """The run's scratch directory for generated inputs and job outputs,
    under the run's own ``TMPDIR``; emptied at the start and the end of a
    run."""
    base = Path(os.environ.get("TMPDIR") or "/tmp")
    return base / f"portbench-{cell}"


def card_description(device) -> dict:
    """``device`` of the result line.  On a card: its name, the number of
    cards used and the peak of the caching allocator."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device.index or 0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or a
    note that it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi printed nothing"


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (``avenir_tpu_torch`` is not ``avenir_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def finite(v: float) -> float:
    """A number the result line can carry: JSON has no infinity, so an
    infinitely late percentile is written as 1e12 ms."""
    return v if math.isfinite(v) else 1e12


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def check_lines(checks: Dict[str, dict]) -> List[str]:
    """One ``name value limit`` line per compared number."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
