"""The port's sequence jobs (``avenir_tpu_torch/models/sequence.py`` on
``core/window.py``) held against the JAX package's on the CPU.

Mirrors ``tests/test_sequence_text.py``'s sequence cases: the GSP join
oracle, the candidate-generation job, the criteria expressions and the
event-locality window, and the positional-cluster job, each through both
packages with byte-equal outputs; the ``event_seq`` datagen preset; and
``resource/event_burst/run.sh`` and ``resource/event_seq_gsp/run.py``
through both packages from scratch copies.
"""

import os

import pytest

from avenir_tpu.core import JobConfig as JaxConfig
from avenir_tpu.core import write_output as jax_write_output
from avenir_tpu.core import window as jwindow
from avenir_tpu.datagen import gen_event_seq as jax_gen_event_seq
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import sequence as jsequence

from avenir_tpu_torch import datagen
from avenir_tpu_torch.core import window
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import sequence
from avenir_tpu_torch.runbook import REPO, run_runbook


def _read(path) -> bytes:
    with open(os.path.join(str(path), "part-r-00000"), "rb") as fh:
        return fh.read()


def _both(tmp_path, cls_name, props, lines, prefix=""):
    jax_write_output(str(tmp_path / "in"), lines)
    getattr(sequence, cls_name)(JobConfig(dict(props), prefix),
                                device="cpu").run(str(tmp_path / "in"),
                                                  str(tmp_path / "out"))
    getattr(jsequence, cls_name)(JaxConfig(dict(props), prefix)).run(
        str(tmp_path / "in"), str(tmp_path / "jout"))
    got = _read(tmp_path / "out")
    assert got == _read(tmp_path / "jout")
    return got.decode().splitlines()


@pytest.mark.parametrize("seqs,want", [
    ([("a", "b"), ("b", "c"), ("b", "d"), ("c", "a")],
     {("a", "b", "c"), ("a", "b", "d"), ("b", "c", "a"), ("c", "a", "b")}),
    ([("x", "x")], {("x", "x", "x")}),
    ([("a", "b")], set()),
])
def test_gsp_candidates_oracle(seqs, want):
    got = sequence.gsp_candidates(seqs)
    assert got == jsequence.gsp_candidates(seqs)
    assert set(got) == want


def test_candidate_generation_job(tmp_path):
    out = _both(tmp_path, "CandidateGenerationWithSelfJoin",
                {"cgs.item.set.length": "2"}, ["a,b", "b,c", "x,x"],
                prefix="cgs")
    assert set(out) == {"a,b,c", "x,x,x"}


def test_candidate_generation_over_event_sequences(tmp_path):
    """Frequent adjacent pairs of 300 generated sequences, self-joined."""
    from collections import Counter

    rows = datagen.gen_event_seq(300, seed=2)
    assert rows == jax_gen_event_seq(300, seed=2)
    pairs = Counter((a, b) for r in rows for a, b in zip(r[1:], r[2:]))
    freq = [f"{a},{b}" for (a, b), c in pairs.items() if c >= 30]
    out = _both(tmp_path, "CandidateGenerationWithSelfJoin",
                {"cgs.item.set.length": "2"}, freq, prefix="cgs")
    assert len(out) > 100


def test_event_seq_preset_is_the_reference_s(tmp_path):
    assert datagen.main(["event_seq", "500", "--seed", "4", "--out",
                         str(tmp_path / "port.csv")]) == 0
    assert jax_datagen(["event_seq", "500", "--seed", "4", "--out",
                        str(tmp_path / "jax.csv")]) == 0
    got = (tmp_path / "port.csv").read_bytes()
    assert got and got == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("expr,cases", [
    ("$0 > 100 && $0 <= 500", [([200, 200], True), ([600, 600], False),
                               ([50, 50], False)]),
    ("$0 < 10 || $0 > 90", [([5], True), ([95], True), ([50], False)]),
])
def test_criteria_expressions(expr, cases):
    c = window.Criteria.create_criteria_from_expression(expr)
    jc = jwindow.Criteria.create_criteria_from_expression(expr)
    assert c.get_num_predicates() == jc.get_num_predicates()
    for vals, want in cases:
        assert c.evaluate(vals) == jc.evaluate(vals) == want
    with pytest.raises(ValueError):
        window.Criteria.create_criteria_from_expression("$0 LIKE 'x'")


def _scores(mod, events, **ctx):
    w = mod.TimeBoundEventLocalityAnalyzer(
        window_time_span=ctx.pop("span"), time_step=1,
        context=mod.EventLocalityContext(**ctx))
    out = []
    for t, met in events:
        w.add(mod.TimeStampedValue(1.0, t, condition_met=met))
        out.append(w.get_score())
    return out


@pytest.mark.parametrize("events,ctx,last", [
    ([(0, False), (40, True), (80, False), (81, True), (82, True),
      (83, True), (84, True)],
     dict(span=100, min_occurence=3, max_interval_average=5,
          max_interval_max=10,
          preferred_strategies=["count", "averageInterval"]), 1.0),
    ([(0, True), (1, True), (50, False)],
     dict(span=10, min_occurence=2, preferred_strategies=["count"]), 0.0),
    ([(0, True), (3, True), (4, True), (9, True)],
     dict(span=20, weighted_strategies={"count": 1.0,
                                        "averageInterval": 2.0},
          min_occurence=3, max_interval_average=2), None),
], ids=["burst", "eviction", "weighted"])
def test_event_locality_window_scores(events, ctx, last):
    got = _scores(window, events, **dict(ctx))
    assert got == _scores(jwindow, events, **dict(ctx))
    if last is not None:
        assert got[-1] == last


def test_positional_cluster_job(tmp_path):
    rows, t = [], 0
    for i in range(30):
        t += 10
        rows.append(f"e{i},10,{t}")       # sparse, not qualifying
    for i in range(5):
        t += 2
        rows.append(f"b{i},80,{t}")       # a qualifying burst
    out = _both(tmp_path, "SequencePositionalCluster", {
        "window.time.span": "50", "processing.time.step": "1",
        "quant.field.ordinal": "1", "seq.num.field.ordinal": "2",
        "weighted.strategy": "false",
        "min.occurence": "3", "max.interval.average": "5",
        "max.interval.max": "10",
        "preferred.strategies": "count,averageInterval",
        "score.threshold": "0.9", "cond.expression": "$0 > 50"}, rows)
    assert out, "the burst should exceed the score threshold"
    assert {l.split(",")[1] for l in out} == {"80"}


RUNBOOKS = {"event_burst": "work/out", "event_seq_gsp": "work/cand3"}


@pytest.fixture(scope="module")
def runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sequence_runbooks")
    env = {"JAX_PLATFORMS": "cpu", "AVENIR_PLATFORM": "cpu"}
    for name in RUNBOOKS:
        src = os.path.join(REPO, "resource", name)
        run_runbook(src, str(tmp / "jax" / name), port=False, env=env)
        run_runbook(src, str(tmp / "port" / name), device="cpu", env=env)
    return tmp


@pytest.mark.parametrize("name", sorted(RUNBOOKS))
def test_sequence_runbooks_match_reference(runbooks, name):
    got = _read(runbooks / "port" / name / RUNBOOKS[name])
    assert got and got == _read(runbooks / "jax" / name / RUNBOOKS[name])
