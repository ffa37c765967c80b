"""Import hygiene and device selection of the PyTorch port.

The port and ``chip_smoke.py`` must import nothing of JAX and nothing of
the JAX package ``avenir_tpu``.  This test process has imported jax
already (tests/conftest.py), so the import check runs in a fresh
interpreter.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "avenir_tpu_torch")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "avenir_tpu" or name.startswith("avenir_tpu."))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import avenir_tpu_torch as p, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'avenir_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'avenir_tpu' or "
        "m.startswith('avenir_tpu.'))\n"
        "print(' '.join(names))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    names = set(run.stdout.split())
    assert len(names) >= 15                     # every module was imported
    assert {f"avenir_tpu_torch.{m}" for m in (
        "models.association", "models.markov", "models.chombo",
        "models.mutual_info", "models.correlation", "models.split",
        "models.tree", "models.pst", "models.text", "models.regress",
        "core.tabular", "core.pipeline", "core.ingestcache", "datagen",
        "serve.engine", "core.multiscan", "core.algebra",
        "models.discriminant", "core.dag", "models.sampler", "core.window",
        "models.sequence", "core.stats", "models.reinforce", "models.bandit",
        "stream.posterior", "runbook")} <= names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_resolve_device_needs_cuda_or_an_explicit_cpu(monkeypatch):
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.device import resolve_device
    from avenir_tpu_torch.models.bayesian import BayesianDistribution

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    schema = os.path.join(REPO, "resource", "churn_nb", "teleComChurn.json")
    cfg = JobConfig({"feature.schema.file.path": schema})
    with pytest.raises(RuntimeError):
        BayesianDistribution(cfg)
    assert BayesianDistribution(cfg, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)


def test_chip_smoke_refuses_without_cuda():
    """No card: the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
