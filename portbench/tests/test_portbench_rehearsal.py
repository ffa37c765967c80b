"""Each driver rehearsed on the CPU at a tiny size: the run is correct,
and its result line has exactly the contract's keys, the checks last."""

import json

import pytest

from _tiny import TINY, run_tiny
from harness import common

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(name, trace, tmp_env):
    res = run_tiny(name, trace)
    assert res["correct"], res["checks"]
    line = json.loads(common.result_line(
        res["correct"], res["attempted"], res["failed"], res["metrics"],
        res["device"], res["checks"], res["breakdown"]))
    keys = list(line)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    assert set(keys) <= set(CONTRACT) | {"breakdown", "checks"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert res["attempted"] > 0 and res["failed"] == 0
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    wanted = common.metrics_for(name)
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in wanted["per_layer"]}
        assert set(line["metrics"]) <= names
    else:
        names = {m["name"] for m in wanted["end_to_end"]}
        assert set(line["metrics"]) == names
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]


def test_no_card_no_result(tmp_env, capsys, monkeypatch):
    """Without a CUDA card the entry point exits non-zero and prints no
    result line."""
    import torch

    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "churn_nb.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
