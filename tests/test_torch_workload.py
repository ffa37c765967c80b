"""The workload harness in the port (``avenir_tpu_torch/workload``), held
against the JAX package's (``avenir_tpu/workload``) on the same inputs:

- every ``resource/workload/*.properties`` schedule serializes to the
  reference's bytes, at the manifest's thread count and at others;
- each generator (arrivals per mode, the Zipf sampler, payload sizes,
  churn and poison rows, feedback faults, the partition) draws what the
  reference draws from the same seeded ``random.Random``;
- verdicts, their JSON file, ``classify`` and ``compile_count`` equal the
  reference's on the same stats;
- the bootstrap's NB model and schema are the reference's bytes;
- end to end on the CPU: a port run passes a small envelope, then fails
  a tightened one with exactly one ``flight-workload-*`` dump, and
  ``workload_smoke.properties`` passes through both packages.

Each test that runs a scenario installs fresh flight recorders in both
packages (the recorder is process-global), so no test here depends on
which file ran before it in the worker.
"""

import glob
import json
import os
import random
import subprocess
import sys

import pytest

from avenir_tpu.core import flight as jflight
from avenir_tpu.core.config import JobConfig as JaxJobConfig
from avenir_tpu.core.config import parse_properties as jax_parse_properties
from avenir_tpu import workload as jwl
from avenir_tpu.workload import generators as jgen
from avenir_tpu.workload import runner as jrunner
from avenir_tpu.workload import verdict as jverdict

from avenir_tpu_torch import workload as wl
from avenir_tpu_torch.core import flight
from avenir_tpu_torch.core.config import JobConfig, parse_properties
from avenir_tpu_torch.workload import generators as gen
from avenir_tpu_torch.workload import runner
from avenir_tpu_torch.workload import verdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(glob.glob(os.path.join(REPO, "resource", "workload",
                                          "*.properties")))


def _both(text: str):
    """The same manifest as a port config and a reference config."""
    return (JobConfig(parse_properties(text)),
            JaxJobConfig(jax_parse_properties(text)))


@pytest.fixture
def fresh_recorders():
    """A fresh process-global flight recorder in each package, the old
    ones restored afterwards."""
    prev = flight.get_recorder(), jflight.get_recorder()
    flight.set_recorder(flight.FlightRecorder())
    jflight.set_recorder(jflight.FlightRecorder())
    yield
    flight.set_recorder(prev[0])
    jflight.set_recorder(prev[1])


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def test_seven_scenarios_are_on_file():
    assert len(SCENARIOS) == 7


@pytest.mark.parametrize("path", SCENARIOS, ids=os.path.basename)
def test_schedule_bytes_equal_the_reference(path):
    text = open(path).read()
    mine, theirs = _both(text)
    got = gen.schedule_bytes(wl.build_schedule(wl.Scenario(mine)))
    want = jgen.schedule_bytes(jwl.build_schedule(jwl.Scenario(theirs)))
    assert got == want and len(got) > 1000


@pytest.mark.parametrize("threads", [1, 3, 16])
def test_schedule_bytes_equal_across_thread_counts(threads):
    """Thread count partitions a finished schedule and never feeds
    generation, in both packages."""
    text = open(os.path.join(REPO, "resource", "workload",
                             "feedback_chaos.properties")).read()
    base = gen.schedule_bytes(wl.build_schedule(wl.Scenario(
        _both(text)[0])))
    other = text.replace("workload.threads=6", f"workload.threads={threads}")
    mine, theirs = _both(other)
    assert gen.schedule_bytes(wl.build_schedule(wl.Scenario(mine))) == base
    assert jgen.schedule_bytes(jwl.build_schedule(
        jwl.Scenario(theirs))) == base


# ---------------------------------------------------------------------------
# the generators, case by case, from the same seeded stream
# ---------------------------------------------------------------------------

def _draws(g, seed):
    rng = random.Random(seed)
    return {
        "constant": g.arrival_offsets("constant", 25.0, 4.0, rng),
        "poisson": g.arrival_offsets("poisson", 60.0, 6.0, rng),
        "flash": g.arrival_offsets("flash", 20.0, 6.0, rng,
                                   surge_factor=8.0),
        "flash_window": g.arrival_offsets("flash", 30.0, 6.0, rng,
                                          surge_factor=5.0,
                                          surge_start_s=1.0,
                                          surge_duration_s=2.5),
        "diurnal": g.arrival_offsets("diurnal", 40.0, 5.0, rng,
                                     period_s=2.0, amplitude=0.7),
        "zipf": [g.ZipfSampler(1000, 1.5).draw(rng) for _ in range(500)],
        "zipf_weights": g.zipf_weights(64, 0.2),
        "hot_share": g.hot_share(g.zipf_weights(1000, 1.5), 20),
        "payload": [g.payload_rows(rng, 2, 0.8, 16) for _ in range(500)],
        "churn": [g.churn_row(rng, i) for i in range(200)],
        "poison": [g.poison_row(rng, i) for i in range(50)],
        "fault": [g.feedback_fault(rng, 0.25, 0.25) for _ in range(500)],
    }


@pytest.mark.parametrize("name", ["constant", "poisson", "flash",
                                  "flash_window", "diurnal", "zipf",
                                  "zipf_weights", "hot_share", "payload",
                                  "churn", "poison", "fault"])
def test_generator_draws_equal_the_reference(name):
    assert _draws(gen, 271828)[name] == _draws(jgen, 271828)[name]


def test_poison_rows_carry_the_marker():
    row = gen.poison_row(random.Random(5), 42)
    fields = row.split(",")
    assert len(fields) == 8 and gen.POISON_MARKER in fields[0]


def test_partition_equals_the_reference():
    text = open(os.path.join(REPO, "resource", "workload",
                             "flash_crowd.properties")).read()
    mine, theirs = _both(text)
    ev = wl.build_schedule(wl.Scenario(mine))
    jev = jwl.build_schedule(jwl.Scenario(theirs))
    for threads in (1, 4, 8):
        got = [gen.schedule_bytes(s) for s in gen.partition(ev, threads)]
        want = [jgen.schedule_bytes(s)
                for s in jgen.partition(jev, threads)]
        assert got == want and len(got) == threads


def test_unknown_arrival_mode_is_refused_as_the_reference_refuses():
    with pytest.raises(ValueError, match="unknown arrival mode"):
        gen.arrival_offsets("burst", 1.0, 1.0, random.Random(0))
    with pytest.raises(ValueError, match="unknown arrival mode"):
        jgen.arrival_offsets("burst", 1.0, 1.0, random.Random(0))


# ---------------------------------------------------------------------------
# verdicts, classify, compile_count
# ---------------------------------------------------------------------------

VERDICT_MANIFEST = """
workload.scenario.name=unit
workload.seed=1234
workload.threads=2
workload.target=serve
workload.bootstrap=none
workload.phases=steady,crowd
workload.phase.steady.arrival=constant
workload.phase.steady.rate=50
workload.phase.steady.duration.sec=2
workload.phase.steady.slo.p99.ms=50
workload.phase.steady.slo.error.max.fraction=0.01
workload.phase.crowd.arrival=flash
workload.phase.crowd.rate=20
workload.phase.crowd.duration.sec=6
workload.phase.crowd.slo.innocents.dropped.max=0
workload.phase.crowd.slo.deferred.max.fraction=0.3
workload.slo.compile.flat=true
workload.slo.fd.growth.max=8
workload.slo.rss.growth.max.mb=64
workload.soak.cycles.min=500
serve.models=m0
"""


def _stats(pkg, name, lat_ms, outcomes, dropped=0):
    st = pkg.PhaseStats(name)
    st.latencies_ms = list(lat_ms)
    st.sent = len(lat_ms)
    st.duration_s = 2.0
    for k, v in outcomes.items():
        st.outcomes[k] = v
    st.innocents_dropped = dropped
    return st


VERDICT_CASES = {
    "pass": (([5.0] * 99 + [20.0], {"ok": 100}),
             ([4.0] * 10, {"ok": 10}, 0), (7, 7),
             ({"fds": 40, "rss_mb": 900.0}, {"fds": 44, "rss_mb": 930.5}),
             (3, 620)),
    "p99_and_errors": (([5.0] * 95 + [400.0] * 5, {"ok": 90, "error": 10}),
                       ([4.0] * 10, {"ok": 7, "deferred": 3}, 1), (7, 9),
                       ({"fds": 40, "rss_mb": 900.0},
                        {"fds": 60, "rss_mb": 901.0}), (0, 12)),
    "no_samples": (([], {}), ([1.0], {"ok": 1}, 0), (None, None),
                   ({"fds": None, "rss_mb": None},
                    {"fds": None, "rss_mb": None}), (None, None)),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_evaluate_run_and_write_verdict_equal_the_reference(case,
                                                             tmp_path):
    steady, crowd, compiles, usage, cycles = VERDICT_CASES[case]
    mine, theirs = _both(VERDICT_MANIFEST)
    docs = []
    for pkg, cfg, write in ((wl, mine, verdict.write_verdict),
                            (jwl, theirs, jverdict.write_verdict)):
        per = {"steady": _stats(pkg, "steady", *steady),
               "crowd": _stats(pkg, "crowd", *crowd)}
        v = pkg.evaluate_run(pkg.Scenario(cfg), per, *compiles, *usage,
                             *cycles)
        path = str(tmp_path / f"{pkg.__name__}.json")
        write(path, v)
        docs.append((v, open(path, "rb").read()))
    assert docs[0] == docs[1]
    assert docs[0][0]["pass"] is (case == "pass")


CLASSIFY_CASES = [
    {"output": "x"}, {"error": "q full", "shed": True},
    {"error": "bad row", "poison": True}, {"error": "t", "timeout": True},
    {"error": "c", "cold_start": True, "retry_after_ms": 50},
    {"error": "boom"}, {"error": "d", "degraded": True, "backend_lost": True},
    {}, {"ok": True},
]


@pytest.mark.parametrize("i", range(len(CLASSIFY_CASES)))
def test_classify_equals_the_reference(i):
    assert wl.classify(CLASSIFY_CASES[i]) == jwl.classify(CLASSIFY_CASES[i])


COMPILE_STATS = [
    {"models": {"a": {"counters": {"Serve": {"Scorer compilations": 7}}}},
     "cache": {"compile_tier": {"compiles": 7, "hits": 400}}},
    {"models": {"a": {"counters": {"Serve": {"Scorer compilations": 3}}},
                "b": {"counters": {"Serve": {"Scorer compilations": 4}}}}},
    {"models": {}}, {},
    {"cache": {"counters": {"Evictions": 37, "Demotes": 4}}},
]


@pytest.mark.parametrize("i", range(len(COMPILE_STATS)))
def test_compile_count_and_demote_cycles_equal_the_reference(i):
    s = COMPILE_STATS[i]
    assert runner.compile_count(s) == jrunner.compile_count(s)
    assert runner.demote_cycles(s) == jrunner.demote_cycles(s)


# ---------------------------------------------------------------------------
# the bootstrap artifact
# ---------------------------------------------------------------------------

def test_bootstrap_model_equals_the_reference(tmp_path):
    """The harness's bootstrap training (1,200 churn rows from the
    scenario's seed) writes the reference's schema and model bytes."""
    path = os.path.join(REPO, "resource", "workload",
                        "workload_smoke.properties")
    mine, theirs = _both(open(path).read())
    assert runner.CHURN_SCHEMA == jrunner.CHURN_SCHEMA
    assert runner.BOOTSTRAP_TRAIN_ROWS == jrunner.BOOTSTRAP_TRAIN_ROWS
    got = runner._train_artifact(wl.Scenario(mine), str(tmp_path / "port"),
                                 device="cpu")
    want = jrunner._train_artifact(jwl.Scenario(theirs),
                                   str(tmp_path / "jax"))
    for a, b in ((got[0], want[0]),
                 (os.path.join(got[1], "part-r-00000"),
                  os.path.join(want[1], "part-r-00000"))):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert os.path.getsize(os.path.join(got[1], "part-r-00000")) > 100


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

E2E_MANIFEST = """
workload.scenario.name=e2e
workload.seed=31
workload.threads=2
workload.target=serve
workload.bootstrap=churn_nb
workload.phases=steady
workload.phase.steady.arrival=constant
workload.phase.steady.rate=30
workload.phase.steady.duration.sec=1.5
workload.phase.steady.slo.p99.ms=2000
workload.phase.steady.slo.error.max.fraction=0.0
workload.warmup.requests=8
serve.warmup=true
serve.port=0
"""


def test_e2e_pass_then_tightened_envelope_dumps_once(tmp_path,
                                                     fresh_recorders):
    """The port's run passes its envelope and writes the run's three
    artifacts; the same manifest with one tightened ceiling exits 1 and
    leaves exactly one ``flight-workload-e2e`` dump naming the phase."""
    out = str(tmp_path / "out")
    base = E2E_MANIFEST + f"workload.out.dir={out}\nflight.dump.dir={out}\n"
    cfg = JobConfig(parse_properties(base))
    flight.configure_from_config(cfg)
    assert runner.run_scenario(cfg, do_assert=True, device="cpu") == 0
    v = json.load(open(os.path.join(out, "verdict.json")))
    assert v["pass"] and v["scenario"] == "e2e"
    assert v["compiles"]["after_warmup"] == v["compiles"]["at_end"]
    tele = json.load(open(os.path.join(out, "telemetry.json")))
    assert any(k.startswith("workload.latency") for k in tele["hists"])
    trace = json.load(open(os.path.join(out, "trace.json")))
    assert trace
    assert not glob.glob(os.path.join(out, "flight-*"))

    tight = JobConfig(parse_properties(
        base + "workload.phase.steady.slo.p99.ms=0.0001\n"))
    assert runner.run_scenario(tight, do_assert=True, device="cpu") == 1
    v = json.load(open(os.path.join(out, "verdict.json")))
    assert not v["pass"] and v["violations"][0]["phase"] == "steady"
    dumps = glob.glob(os.path.join(out, "flight-workload-e2e-*.jsonl"))
    assert len(dumps) == 1
    anomaly = [r for r in map(json.loads, open(dumps[0]))
               if r.get("kind") == "anomaly"]
    assert anomaly[0]["reason"] == "workload-e2e"
    assert anomaly[0]["phase"] == "steady" and anomaly[0]["violations"]


def test_workload_smoke_passes_through_both_packages(tmp_path):
    """``resource/workload/workload_smoke.properties`` (CI gate 3) with
    its own envelopes, through each package's command line in turn
    (``python -m avenir_tpu_torch workload ... --assert --device cpu``
    and the reference's): both verdicts pass, over the same schedule and
    the same bootstrap model."""
    path = os.path.join(REPO, "resource", "workload",
                        "workload_smoke.properties")
    # as CI runs it: one CPU device (not this suite's eight virtual ones,
    # over which the reference's server would spread its replicas)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    verdicts = {}
    for tag, cmd in (("port", ["avenir_tpu_torch", "workload", "--device",
                               "cpu"]),
                     ("jax", ["avenir_tpu", "workload"])):
        out = str(tmp_path / tag)
        run = subprocess.run(
            [sys.executable, "-m"] + cmd + [
                "--scenario", path, "--assert",
                f"-Dworkload.out.dir={out}"],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300)
        assert run.returncode == 0, (tag, run.stderr[-3000:])
        assert "verdict: PASS" in run.stderr
        verdicts[tag] = json.load(open(os.path.join(out, "verdict.json")))
    mine, theirs = verdicts["port"], verdicts["jax"]
    assert mine["pass"] and theirs["pass"]
    assert ([p["summary"]["sent"] for p in mine["phases"]]
            == [p["summary"]["sent"] for p in theirs["phases"]])
    assert (open(tmp_path / "port" / "bootstrap" / "nb_model" /
                 "part-r-00000", "rb").read()
            == open(tmp_path / "jax" / "bootstrap" / "nb_model" /
                    "part-r-00000", "rb").read())


def test_workload_main_flags(tmp_path, capsys):
    """``--device`` is taken by the entry point; a missing scenario is a
    usage error as in the reference."""
    assert runner.workload_main(["--help"]) == 2
    assert runner.workload_main(["--device", "cpu"]) == 2
    assert "--scenario" in capsys.readouterr().err


def test_chip_smoke_schedule_digests_are_the_reference_bytes():
    """``chip_smoke.py`` holds the card machine's schedules (it has no
    jax) to digests of the reference's bytes: each digest is the JAX
    package's schedule for that scenario."""
    import hashlib

    import chip_smoke

    assert sorted(chip_smoke.WORKLOAD_SCHEDULES) == sorted(
        os.path.basename(p)[:-len(".properties")] for p in SCENARIOS)
    for name, digest in chip_smoke.WORKLOAD_SCHEDULES.items():
        path = os.path.join(REPO, "resource", "workload",
                            f"{name}.properties")
        theirs = _both(open(path).read())[1]
        want = jgen.schedule_bytes(jwl.build_schedule(jwl.Scenario(theirs)))
        assert hashlib.sha256(want).hexdigest() == digest, name
