"""The shared-scan churn workflow's benchmark (``churn_multiscan.scan``):
the cell rehearsed on the CPU at a tiny size, traced and untraced; its
plain reference worked by hand on eight rows; the faults its check has
to catch planted in the program on the CPU; and its float32 control,
which has to come out not correct at the cell's own size."""

import json
import math

import numpy as np
import pytest

from _tiny import SECONDS, SEED
from harness import common

CELL = "churn_multiscan.scan"
#: rows a test run on the CPU holds
TINY_ROWS = 20000
REF = common.load_module(common.BENCH_DIR / "refs" / "churn_multiscan.py",
                         "portbench_refs_churn_multiscan")
GEN = common.load_module(common.BENCH_DIR / "gen" / "churn_multiscan.py",
                         "portbench_gen_churn_multiscan")
CFG = common.load_cell(CELL)["config_file"]

# eight rows: plan decides the class, minUsed mostly, csCall a little,
# dataUsed (independent of the class), csEmail and network (constant) not
HAND = {"plan":     [0, 0, 0, 0, 1, 1, 1, 1],
        "minUsed":  [0, 0, 0, 200, 200, 200, 200, 200],
        "dataUsed": [0, 0, 100, 100, 0, 0, 100, 100],
        "csCall":   [0, 0, 0, 0, 0, 0, 0, 2],
        "csEmail":  [0] * 8,
        "network":  [0] * 8,
        "churned":  [0, 0, 0, 0, 1, 1, 1, 1]}


def run_tiny(trace=False, extra=None):
    """One run of the cell on the CPU at ``TINY_ROWS``, past the look for
    a card; ``extra`` overrides more of the cell (``_tiny.run_tiny``'s
    contract)."""
    import time

    import torch

    import run
    ov = {"assumed": {"train_rows": TINY_ROWS}}
    ov.update(extra or {})
    return run.run_cell(CELL, SEED, SECONDS, trace, torch.device("cpu"),
                        time.perf_counter(), overrides=ov)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(trace, tmp_env):
    """The run is correct and its result line has the contract's keys, the
    checks last; traced, every per-layer metric listed for the cell that
    reads spans reads a value."""
    res = run_tiny(trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    line = json.loads(common.result_line(
        res["correct"], res["attempted"], res["failed"], res["metrics"],
        res["device"], res["checks"], res["breakdown"]))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert set(line["checks"]) == {"output_lines_differing",
                                   "standalone_reruns"}
    wanted = common.metrics_for(CELL)
    if trace:
        spans = {m["name"] for m in wanted["per_layer"]
                 if m["source"] == "program_span"}
        assert spans <= set(line["metrics"]), spans - set(line["metrics"])
        assert {"multiscan.encode_share", "multiscan.fold_share",
                "multiscan.finalize_share"} <= spans
    else:
        assert set(line["metrics"]) == {m["name"] for m in
                                        wanted["end_to_end"]}
        assert all(m["value"] > 0 for m in line["metrics"].values())


def _section(lines, head):
    k = lines.index(head) + 1
    end = next((j for j in range(k, len(lines))
                if ":" in lines[j] and "," not in lines[j]), len(lines))
    return lines[k:end]


def test_reference_by_hand():
    cols = {k: np.asarray(v) for k, v in HAND.items()}
    out = REF.outputs(cols)
    assert out["nb"][:6] == ["N,1,planA,4", "N,,,4", ",1,planA,4",
                             "N,2,0,3", "N,,,3", ",2,0,3"]
    assert "Y,1,planA" not in "\n".join(out["nb"])
    mi = out["mi"]
    assert _section(mi, "distribution:class") == ["N,0.5", "Y,0.5"]
    assert _section(mi, "distribution:feature")[:4] == [
        "1,planA,0.5", "1,planB,0.5", "2,0,0.375", "2,1,0.625"]
    assert "1,planA,N,0.5" in _section(mi, "distribution:featureClass")
    assert "2,1,Y,1.0" not in _section(
        mi, "distribution:featureClassConditional")
    assert "2,Y,1,1.0" in _section(mi, "distribution:featureClassConditional")
    mim = [l.split(",") for l in _section(
        mi, "mutualInformationScoreAlgorithm: mutual.info.maximization")]
    assert [int(o) for o, _ in mim] == [1, 2, 4, 3, 5, 6]
    want = [math.log(2),
            0.375 * math.log(2) + 0.125 * math.log(0.4)
            + 0.5 * math.log(1.6),
            0.5 * math.log(8 / 7) + 0.375 * math.log(6 / 7)
            + 0.125 * math.log(2), 0.0, 0.0, 0.0]
    assert [float(v) for _, v in mim] == pytest.approx(want, abs=1e-15)
    assert out["corr"] == ["plan,churned,1.0"]
    assert out["stats"] == [
        f"2,0,1000.0,200000.0,8.0,125.0,9375.0,{math.sqrt(9375)}",
        f"2,N,200.0,40000.0,4.0,50.0,7500.0,{math.sqrt(7500)}",
        "2,Y,800.0,160000.0,4.0,200.0,0.0,0.0",
        "3,0,400.0,40000.0,8.0,50.0,2500.0,50.0",
        "3,N,200.0,20000.0,4.0,50.0,2500.0,50.0",
        "3,Y,200.0,20000.0,4.0,50.0,2500.0,50.0"]
    assert REF.lines_differing(out, out) == 0
    bent = dict(out, stats=out["stats"][:-1])
    assert REF.lines_differing(bent, out) == 1


def _small_chunks():
    """The manifest at 4,096-row chunks: five chunks of the tiny file."""
    wf = dict(CFG["files"]["workflow.properties"],
              **{"pipeline.chunk.rows": "4096"})
    return {"files": {"workflow.properties": wf}}


def _mi_skips_a_chunk(mod, monkeypatch):
    orig = mod._MIFoldSpec.encode
    calls = {}

    def encode(self, ctx):
        out = orig(self, ctx)
        k = calls[id(self)] = calls.get(id(self), 0) + 1
        return None if k == 2 else out
    monkeypatch.setattr(mod._MIFoldSpec, "encode", encode)


def _moment_altered(mod, monkeypatch):
    orig = mod._moment_rows

    def rows(vals, groups):
        out = orig(vals, groups)
        out[-1][1][1] += 1.0                  # one sum of squares
        return out
    monkeypatch.setattr(mod, "_moment_rows", rows)


def _cramer_withdraws(mod, monkeypatch):
    from avenir_tpu_torch.core.binning import ChunkedEncodeUnsupported

    def encode(self, ctx):
        raise ChunkedEncodeUnsupported("planted")
    monkeypatch.setattr(mod._CatCorrFoldSpec, "encode", encode)


FAULTS = {"one chunk left out of MI's fold": ("mutual_info",
                                              _mi_skips_a_chunk,
                                              "output_lines_differing"),
          "a stats moment altered": ("discriminant", _moment_altered,
                                     "output_lines_differing"),
          "a job re-run standalone": ("correlation", _cramer_withdraws,
                                      "standalone_reruns")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, tmp_env, monkeypatch):
    import importlib
    mod_name, plant, check = FAULTS[fault]
    plant(importlib.import_module(f"avenir_tpu_torch.models.{mod_name}"),
          monkeypatch)
    res = run_tiny(extra=_small_chunks())
    assert not res["correct"], res["checks"]
    assert res["checks"][check]["value"] > 0, res["checks"]


def test_small_chunks_alone_are_correct(tmp_env):
    """The faults' five-chunk manifest with nothing planted."""
    res = run_tiny(extra=_small_chunks())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [2 ** 31 + 321, 2 ** 31 + 322,
                                  2 ** 31 + 323])
def test_float32_control_fails_at_cell_size(seed):
    """The reference in float32, in the program's place, at the cell's
    1,600,000 rows: its outputs are not the float64 reference's."""
    rows = int(CFG["assumed"]["train_rows"])
    assert rows > TINY_ROWS
    data = GEN.make(seed, rows, 0)["train"]
    want = REF.outputs(data)
    got = REF.outputs(data, "float32")
    diff = REF.lines_differing(got, want)
    print({"seed": seed, "output_lines_differing": diff})
    assert diff > REF.LIMITS["output_lines_differing"]
    assert got["nb"] == want["nb"]            # counts are exact in float32
    assert got["stats"] != want["stats"] and got["corr"] != want["corr"]


def test_reference_loads_nothing_of_the_program():
    """In a fresh interpreter: the generator and the reference, through
    the control, load neither torch nor the port nor JAX."""
    import json
    import subprocess
    import sys
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(common.BENCH_DIR)!r}]\n"
        "from harness import common\n"
        "g = common.load_module(common.BENCH_DIR / 'gen' / "
        "'churn_multiscan.py', 'g')\n"
        "r = common.load_module(common.BENCH_DIR / 'refs' / "
        "'churn_multiscan.py', 'r')\n"
        "d = g.make(3, 500, 0)['train']\n"
        "r.outputs(d); r.outputs(d, 'float32')\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] "
        "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert not names & {"torch", "avenir_tpu_torch", "avenir_tpu", "jax",
                        "jaxlib", "flax"}, sorted(names)


def test_configuration_is_its_own():
    """No other configuration of the benchmark has this one's source and
    reduced keys: with the same of both it would be that configuration
    again, whatever its file holds."""
    spec = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    by_name = {c["name"]: c for c in spec["configs"]}
    mine = by_name[CFG["name"]]
    assert CFG["source"] == mine["source"]
    for name, c in by_name.items():
        if name != mine["name"]:
            assert (c["source"], sorted(c["reduced"])) != \
                (mine["source"], sorted(mine["reduced"])), name
