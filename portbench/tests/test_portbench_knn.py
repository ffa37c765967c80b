"""The kNN cell and the warm NB cell: ``knn_pipeline`` and
``batch_job`` with the ingest cache rehearsed on the CPU at a tiny size
(the run is correct, its result line has the contract's keys and the
readers that list the cell); the kNN configuration's files and names; the
``k3_roofline`` reader on hand-made device events; the reference
importing nothing of the program; and, on a card (``-m card``), the
reference's bfloat16 control failing at the cell's own size."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import common
from harness.devtrace import DeviceTrace
from harness.layer import LayerContext

import run

TINY = {"knn_elearn.classify": {"assumed": {"train_rows": 3000,
                                            "test_rows": 300}},
        "churn_nb.train_warm": {"assumed": {"train_rows": 20000}}}
SEED = 2 ** 31 + 907
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, trace):
    return run.run_cell(name, SEED, 1.5, trace, torch.device("cpu"),
                        time.perf_counter(), overrides=TINY[name])


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(name, trace, tmp_env):
    res = _run(name, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    line = json.loads(common.result_line(
        res["correct"], res["attempted"], res["failed"], res["metrics"],
        res["device"], res["checks"], res["breakdown"]))
    keys = list(line)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    wanted = common.metrics_for(name)
    if trace:
        names = {m["name"] for m in wanted["per_layer"]}
        assert set(line["metrics"]) <= names
        if name == "knn_elearn.classify":
            # every span reader of the cell reads its spans on the CPU
            assert set(line["metrics"]) >= {
                "ingest.parse_share", "knn.distance_share",
                "knn.emit_share", "knn.vote_share", "host.gc_share",
                "job.plumbing_share"}
        else:
            # the cache read leaves the parse out and the fold's waits in
            assert "ingest.parse_share" not in line["metrics"]
            assert set(line["metrics"]) >= {
                "ingest.wait_share", "job.plumbing_share", "host.gc_share"}
    else:
        assert set(line["metrics"]) == {m["name"]
                                        for m in wanted["end_to_end"]}


def test_knn_configuration_files():
    cell = common.load_cell("knn_elearn.classify")
    cfg = cell["config_file"]
    files = cfg["files"]
    p = cell["params"]
    assert {p["distance_properties"], p["vote_properties"]} <= set(files)
    sim, vote = files["sim.properties"], files["knn.properties"]
    assert sim["base.set.split.prefix"] == "tr"
    assert sim["output.top.matches"] == str(cfg["sizes"]["k"]) == "5"
    assert sim["distance.scale"] == str(cfg["sizes"]["scale"]) == "1000"
    assert vote["top.match.count"] == "5"
    assert vote["kernel.function"] == "none"
    assert vote["validation.mode"] == "true"
    assert sim["feature.schema.file.path"] == "elearn.json"
    schema = json.loads((common.ROOT / "resource" / "elearn_nb"
                         / "elearn.json").read_text())
    assert files["elearn.json"] == schema
    ref = common.load_module(common.BENCH_DIR / "refs" / "knn_elearn.py")
    feats = [f for f in schema["fields"] if f.get("feature")]
    assert [(f["name"], f["min"], f["max"]) for f in feats] == \
        list(ref.FEATURES)
    assert cfg["sizes"]["features"] == len(feats) == 9
    assert cfg["reduced"] == []
    gen = common.load_module(common.BENCH_DIR / "gen" / "knn_elearn.py")
    assert list(gen.FIELDS) == [f["name"] for f in feats]


def test_generator_ids_unique_and_seeded():
    gen = common.load_module(common.BENCH_DIR / "gen" / "knn_elearn.py")
    a = gen.make(SEED, 2000, 200)
    b = gen.make(SEED, 2000, 200)
    for part in ("train", "pool"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k])
    lines = gen.csv_bytes(a["train"], b"T").decode().splitlines()
    assert len(lines) == len(set(l.split(",")[0] for l in lines)) == 2000
    assert lines[1].split(",")[0] == "T0000001"
    f = lines[5].split(",")
    assert f[10] == "PF"[a["train"]["status"][5]]
    assert [int(v) for v in f[1:10]] == [int(a["train"][n][5])
                                         for n in gen.FIELDS]
    share = gen.make(SEED, 20000, 0)["train"]["status"].mean()
    assert 0.3 < share < 0.5


def _event_ctx(events, jobs, cfg):
    dev = DeviceTrace(torch.device("cpu"))
    dev.events = events
    return LayerContext([], dev, 0, 10_000, {
        "job_spans_ns": jobs, "counters": {"k3_launches": len(jobs)}}, cfg)


def test_k3_roofline_reads_the_kernels_of_each_job():
    reader = common.load_module(common.BENCH_DIR / "layer_metrics"
                                / "k3_roofline.py")
    cfg = {"sizes": {"features": 9, "k": 5},
           "assumed": {"train_rows": 1000, "test_rows": 100}}
    ops, nbytes = reader.work(9, 100, 1000, 5)
    assert ops == 2 * 9 * 100 * 1000
    assert nbytes == 4 * 9 * 1100 + 8 * 5 * 100
    least = reader.least_seconds(nbytes, ops)
    events = [("void (anonymous namespace)::layout_kernel(float*)", 10, 1000),
              ("void (anonymous namespace)::topk_kernel<128>(float*)", 20,
               3000),
              ("void at::native::vectorized_elementwise_kernel", 30, 5000),
              ("void (anonymous namespace)::topk_kernel<128>(float*)", 5010,
               4000),
              # a job whose K3 the profiler dropped is left out
              ("void (anonymous namespace)::layout_kernel(float*)", 8010, 9)]
    jobs = [(0, 5000), (5000, 8000), (8000, 9000)]
    got = reader.read(_event_ctx(events, jobs, cfg))
    assert got == pytest.approx(100 * 2 * least / 8000e-9)
    assert reader.read(_event_ctx([], jobs, cfg)) is None
    ctx = _event_ctx(events, jobs, cfg)
    ctx.facts["counters"] = {}
    assert reader.read(ctx) is None


def test_knn_ref_loads_nothing_of_the_program(tmp_env):
    code = f"""
import json, sys
sys.path[:0] = [{str(common.BENCH_DIR)!r}]
from harness import common
g = common.load_module(common.BENCH_DIR / "gen" / "knn_elearn.py", "g")
r = common.load_module(common.BENCH_DIR / "refs" / "knn_elearn.py", "r")
d = g.make(3, 500, 50)
dist, idx = r.nearest(d["train"], d["pool"], 5, 1000)
lines = r.control_pair_lines(d["train"], d["pool"], 5, 1000)
r.check_pairs(lines, d["train"], d["pool"], dist, idx, 1000)
r.vote(lines, 5)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"avenir_tpu_torch", "avenir_tpu", "jax", "jaxlib",
                      "flax"}


@pytest.mark.card
def test_knn_control_fails_at_cell_size(card):
    """The reference computed in bfloat16, in the program's place at the
    cell's own size, falls outside the pair contract; each seed's
    readings are printed for PERF.md."""
    cfg = common.load_cell("knn_elearn.classify")["config_file"]
    gen = common.load_module(common.BENCH_DIR / "gen" / "knn_elearn.py")
    ref = common.load_module(common.BENCH_DIR / "refs" / "knn_elearn.py")
    n_train, n_test = (cfg["assumed"]["train_rows"],
                       cfg["assumed"]["test_rows"])
    k, scale = cfg["sizes"]["k"], cfg["sizes"]["scale"]
    for seed in (2 ** 31 + 321, 2 ** 31 + 322, 2 ** 31 + 323):
        d = gen.make(seed, n_train, n_test)
        t0 = time.perf_counter()
        dist, idx = ref.nearest(d["train"], d["pool"], k, scale, card)
        t1 = time.perf_counter()
        lines = ref.control_pair_lines(d["train"], d["pool"], k, scale, card)
        got = ref.check_pairs(lines, d["train"], d["pool"], dist, idx, scale)
        got["predictions_differing"] = ref.check_predictions(
            lines, ref.vote(lines, k)[0], ref.vote(lines, k)[1], k)
        print(json.dumps({"seed": seed, "float64_pass_s": t1 - t0,
                          "control": got}), flush=True)
        assert got["pairs_outside_contract"] > ref.LIMITS[
            "pairs_outside_contract"], got
