"""The port's copies of the chombo legs (``avenir_tpu_torch/models/chombo.py``:
TemporalFilter, Projection, RunningAggregator) held against the JAX
package's on the CPU: every case of tests/test_chombo.py runs through both
and must write the same bytes and counters."""

import os

import pytest

from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.models import chombo as jc
from avenir_tpu.models.bandit import aggregate_rewards as jax_aggregate

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import chombo as tc


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _read(path):
    with open(os.path.join(path, "part-r-00000")) as fh:
        return fh.read()


def _both(tmp_path, job, props, prefix="", tag="out"):
    """``job`` of each package over ``tmp_path/in``; returns the port's
    output lines and counters after checking them against the
    reference's."""
    want_c = getattr(jc, job)(JaxConfig(dict(props), prefix)).run(
        str(tmp_path / "in"), str(tmp_path / f"{tag}_jax"))
    got_c = getattr(tc, job)(JobConfig(dict(props), prefix),
                             device="cpu").run(
        str(tmp_path / "in"), str(tmp_path / f"{tag}_port"))
    got = _read(tmp_path / f"{tag}_port")
    assert got == _read(tmp_path / f"{tag}_jax")
    assert got_c.format() == want_c.format()
    return got.splitlines(), got_c


def test_temporal_filter_any_time_range(tmp_path):
    rows = [f"T{i},{1000 + 100 * i},I1,I2" for i in range(10)]
    _write(str(tmp_path / "in" / "part-00000"), rows)
    got, c = _both(tmp_path, "TemporalFilter", {
        "tef.time.stamp.field.ordinal": "1", "tef.time.range": "1200:1500",
        "tef.seasonal.cycle.type": "anyTimeRange"}, "tef")
    assert got == rows[2:6]
    assert c.get("Basic", "Records emitted") == 4


def test_temporal_filter_mili_shift_and_multi_range(tmp_path):
    rows = ["a,1000000,x", "b,2000000,x", "c,3000000,x"]
    _write(str(tmp_path / "in" / "part-00000"), rows)
    got, c = _both(tmp_path, "TemporalFilter", {
        "tef.time.stamp.field.ordinal": "1", "tef.time.stamp.in.mili": "true",
        "tef.time.zone.shift.hours": "1",
        "tef.time.range": "4500:4700,6500:6700"}, "tef")
    assert got == ["a,1000000,x", "c,3000000,x"]
    assert c.get("Basic", "Records read") == 3


@pytest.mark.parametrize("props", [
    {"tef.seasonal.cycle.type": "lunarPhase", "tef.time.range": "0:2"},
    {"tef.time.range": "0-2"}])
def test_temporal_filter_rejects_what_the_reference_rejects(tmp_path, props):
    _write(str(tmp_path / "in" / "part-00000"), ["a,1,x"])
    props = dict(props, **{"tef.time.stamp.field.ordinal": "1"})
    for mod, cfg, kw in ((jc, JaxConfig, {}), (tc, JobConfig,
                                               {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.TemporalFilter(cfg(dict(props), "tef"), **kw).run(
                str(tmp_path / "in"), str(tmp_path / "out"))


MON0030 = 1614558600                     # 2021-03-01 00:30 UTC, a Monday
SEASONAL_ROWS = [f"a,{MON0030},x", f"b,{MON0030 + 9 * 3600},x",
                 f"c,{MON0030 + 13 * 3600},x",
                 f"d,{MON0030 + 9 * 3600 + 5 * 86400},x"]


@pytest.mark.parametrize("cycle,window,want", [
    ("hourOfDay", "9:16", [1, 2, 3]), ("dayOfWeek", "1:1", [0, 1, 2]),
    ("weekDayOrWeekEnd", "1:1", [3]), ("quarterHourOfDay", "2:2", [0]),
    ("monthOfYear", "2:2", [0, 1, 2, 3]), ("halfHourOfDay", "1:1", [0])])
def test_temporal_filter_seasonal_cycles(tmp_path, cycle, window, want):
    _write(str(tmp_path / "in" / "part-00000"), SEASONAL_ROWS)
    got, _ = _both(tmp_path, "TemporalFilter", {
        "tef.time.stamp.field.ordinal": "1", "tef.time.range": window,
        "tef.seasonal.cycle.type": cycle}, "tef")
    assert got == [SEASONAL_ROWS[i] for i in want]


def test_projection_grouping_ordering_compact(tmp_path):
    rows = ["c1,x3,2013-02-01,30", "c2,x1,2013-01-05,70",
            "c1,x2,2013-01-15,50", "c1,x1,2013-01-01,40"]
    _write(str(tmp_path / "in" / "part-00000"), rows)
    got, c = _both(tmp_path, "Projection", {
        "projection.operation": "groupingOrdering", "key.field": "0",
        "orderBy.field": "2", "projection.field": "2,3",
        "format.compact": "true"})
    assert got == ["c1,2013-01-01,40,2013-01-15,50,2013-02-01,30",
                   "c2,2013-01-05,70"]
    assert c.get("Basic", "Groups") == 2


def test_projection_per_record_numeric_order_and_stability(tmp_path):
    _write(str(tmp_path / "in" / "part-00000"),
           ["g,a,2,first", "g,b,10,second", "g,c,2,third"])
    got, _ = _both(tmp_path, "Projection", {
        "projection.operation": "groupingOrdering", "key.field": "0",
        "orderBy.field": "2", "projection.field": "3"})
    assert got == ["g,first", "g,third", "g,second"]


def test_projection_plain_project(tmp_path):
    _write(str(tmp_path / "in" / "part-00000"), ["a,b,c", "d,e,f"])
    got, _ = _both(tmp_path, "Projection", {"projection.operation": "project",
                                            "projection.field": "2,0"})
    assert got == ["c,a", "f,d"]


def test_running_aggregator_matches_library_math(tmp_path):
    prev = ["p0,k0,2,100", "p0,k1,0,0"]
    inc1 = ["p0,k0,40", "p0,k1,300"]
    inc2 = ["p0,k0,70"]
    _write(str(tmp_path / "in" / "part-00000"), prev)
    _write(str(tmp_path / "in" / "inc_return1.txt"), inc1)
    _write(str(tmp_path / "in" / "inc_return2.txt"), inc2)
    got, c = _both(tmp_path, "RunningAggregator", {
        "quantity.attr": "2", "incremental.file.prefix": "inc"})
    assert c.get("Basic", "Incremental records") == 3
    assert tc.aggregate_rewards(inc1 + inc2, prev) == \
        jax_aggregate(inc1 + inc2, prev)
    assert set(got) == set(tc.aggregate_rewards(inc1 + inc2, prev))
    assert "p0,k0,4,77" in got
