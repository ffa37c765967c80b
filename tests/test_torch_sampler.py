"""The port's sampling jobs (``avenir_tpu_torch/models/sampler.py``) held
against the JAX package's on the CPU.

Mirrors ``tests/test_explore.py``'s sampler cases: the same seeded input
through ``BaggingSampler`` and ``UnderSamplingBalancer`` in both packages
must give the same bytes (both draw from numpy's seeded generator), with
the reference's own checks on top; ``resource/class_balance/run.sh`` runs
through both command lines from scratch copies.
"""

import os

import numpy as np
import pytest

from avenir_tpu.core import JobConfig as JaxConfig
from avenir_tpu.core import write_output as jax_write_output
from avenir_tpu.models import sampler as jsampler

from avenir_tpu_torch.cli import job_class
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import sampler
from avenir_tpu_torch.runbook import REPO, run_runbook


def _read(path) -> bytes:
    with open(os.path.join(str(path), "part-r-00000"), "rb") as fh:
        return fh.read()


def _both(tmp_path, cls_name, props, lines):
    jax_write_output(str(tmp_path / "in"), lines)
    getattr(sampler, cls_name)(JobConfig(dict(props)), device="cpu").run(
        str(tmp_path / "in"), str(tmp_path / "out"))
    getattr(jsampler, cls_name)(JaxConfig(dict(props))).run(
        str(tmp_path / "in"), str(tmp_path / "jout"))
    got = _read(tmp_path / "out")
    assert got == _read(tmp_path / "jout")
    return got.decode().splitlines()


@pytest.mark.parametrize("seed,batch", [(1, 100), (7, 64), (3, 1000)])
def test_bagging_sampler(tmp_path, seed, batch):
    lines = [f"row{i}" for i in range(250)]
    out = _both(tmp_path, "BaggingSampler",
                {"batch.size": str(batch), "sampling.seed": str(seed)}, lines)
    assert len(out) == 250                       # per-batch size preserved
    assert set(out) <= set(lines)
    assert len(set(out)) < 250                   # with replacement: dupes


@pytest.mark.parametrize("seed,distr", [(2, 200), (5, 50), (9, 5000)])
def test_undersampling_balancer(tmp_path, seed, distr):
    rows = ([f"r{i},MAJ" for i in range(900)]
            + [f"r{i},MIN" for i in range(100)])
    np.random.default_rng(0).shuffle(rows)
    out = _both(tmp_path, "UnderSamplingBalancer",
                {"class.attr.ord": "1", "distr.batch.size": str(distr),
                 "sampling.seed": str(seed)}, rows)
    assert sum(1 for l in out if l.endswith("MIN")) == 100
    assert sum(1 for l in out if l.endswith("MAJ")) < 350


def test_registry_builds_both_jobs_on_the_asked_device():
    for name in ("BaggingSampler", "UnderSamplingBalancer",
                 "org.avenir.explore.BaggingSampler"):
        job = job_class(name)(JobConfig({"class.attr.ord": "1"}),
                              device="cpu")
        assert job.device.type == "cpu"


@pytest.fixture(scope="module")
def class_balance(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_class_balance")
    src = os.path.join(REPO, "resource", "class_balance")
    env = {"JAX_PLATFORMS": "cpu", "AVENIR_PLATFORM": "cpu"}
    run_runbook(src, str(tmp / "jax"), port=False, env=env)
    log = run_runbook(src, str(tmp / "port"), device="cpu", env=env)
    return tmp, log


@pytest.mark.parametrize("out", ["in", "balanced", "bagged"])
def test_class_balance_runbook_matches_reference(class_balance, out):
    tmp, log = class_balance
    if out == "in":
        got = open(tmp / "port" / "work" / "in" / "part-00000", "rb").read()
        want = open(tmp / "jax" / "work" / "in" / "part-00000", "rb").read()
    else:
        got = _read(tmp / "port" / "work" / out)
        want = _read(tmp / "jax" / "work" / out)
    assert got and got == want
    assert "Sampling\tEmitted" in log
