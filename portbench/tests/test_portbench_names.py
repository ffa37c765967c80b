"""BENCHMARK.json against the contract's shapes: keys, names, units and
lengths, the files each entry names, and what every cell reports."""

import json
import re

import pytest

from harness import common

SPEC = json.loads((common.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == TOP
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (common.ROOT / p).is_dir()


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries(section, keys):
    entries = SPEC[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - keys
        assert keys <= set(e) and extra <= {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert _line(e[k])
        if "layer" in e:
            assert _line(e["layer"])


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (common.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.loads((common.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["name"] == c["name"]


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = common.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["traffic"] == w["traffic"]
        assert (common.BENCH_DIR / "drivers" / f"{cell['driver']}.py").is_file()
        for kind in ("gen", "refs"):
            assert (common.BENCH_DIR / kind / f"{w['config']}.py").is_file()


def test_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        got = common.metrics_for(w["name"], SPEC)
        e2e = [m["name"] for m in got["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert got["per_layer"], w["name"]
        for m in got["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_layer_metrics_have_readers():
    layers = {}
    for m in SPEC["per_layer"]:
        assert (common.BENCH_DIR / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert layers
