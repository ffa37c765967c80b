"""No run loads JAX or the JAX package, and the references load nothing
of the program: each checked in a fresh interpreter, by the top-level
names of ``sys.modules`` compared whole."""

import json
import subprocess
import sys

import pytest

from harness import common

RUN_CELL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
sys.path.insert(0, {tests!r})
from _tiny import run_tiny
res = run_tiny({name!r}, trace={trace})
assert res["correct"], res["checks"]
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFS = """
import json, sys
sys.path[:0] = [{bench!r}]
from harness import common
import numpy as np
for c in ("churn_nb", "churn_markov"):
    g = common.load_module(common.BENCH_DIR / "gen" / f"{{c}}.py", "g" + c)
    r = common.load_module(common.BENCH_DIR / "refs" / f"{{c}}.py", "r" + c)
    d = g.make(3, 500, 50)
    r.model_lines(d["train"])
    s = r.Scorer(d["train"])
    r.expected_outputs(s, d["pool"], np.arange(10), "Q")
    r.expected_outputs(s, d["pool"], np.arange(10), "Q", "bfloat16")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_names(code, tmp_env):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**__import__("os").environ,
                              "TMPDIR": str(tmp_env)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name,trace", [("churn_nb.train", True),
                                        ("churn_markov.serve", True)])
def test_a_run_loads_no_jax(name, trace, tmp_env):
    code = RUN_CELL.format(bench=str(common.BENCH_DIR), root=str(common.ROOT),
                           tests=str(common.BENCH_DIR / "tests"), name=name,
                           trace=trace)
    top = _top_names(code, tmp_env)
    assert "avenir_tpu_torch" in top
    assert not top & set(common.FORBIDDEN_MODULES)


def test_refs_load_nothing_of_the_program(tmp_env):
    code = REFS.format(bench=str(common.BENCH_DIR))
    top = _top_names(code, tmp_env)
    assert not top & {"avenir_tpu_torch", "avenir_tpu", "jax", "jaxlib",
                      "flax"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "avenir_tpu_torch_x", sys)
    assert "avenir_tpu_torch_x" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in common.forbidden_loaded()
