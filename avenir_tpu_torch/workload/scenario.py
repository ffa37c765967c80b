"""Scenario manifests: the ``workload.*`` properties surface.

A scenario is ONE properties file (the same Java-properties dialect
every other subsystem uses) declaring three things:

- the **fleet**: seed, client thread count, target (``serve`` or
  ``stream``), tenant universe and its Zipf popularity, payload mix;
- the **phases**: an ordered list of named traffic phases, each with an
  arrival process (constant / poisson / flash / diurnal), a rate, a
  duration, and optional poison / feedback-chaos dials;
- the **SLO envelope**: per-phase ceilings (p99, error fraction, shed
  fraction, dropped innocents) plus the run-level compile-flatness
  gate.  The verdict engine (``workload.verdict``) judges the run
  against exactly these declared numbers — a scenario file IS the
  regression test.

Per-phase keys follow the ``workload.phase.<name>.<suffix>`` grammar
(runtime-derived like ``serve.model.<name>.*`` — documented as a key
FAMILY in the README; the config-keys rule governs the scalar
``workload.*`` keys below).  The manifest may also carry ``serve.*`` /
``stream.*`` keys verbatim: the runner builds the system under test
from the same config object, so one file describes the whole
experiment.
"""

from __future__ import annotations

import random
from typing import List, Optional

from ..core.config import JobConfig
from ..stream import posterior
from . import generators as gen
from .generators import Event

# -- governed scenario keys (config-keys rule: KEY_-bound, accessor-read,
# README-documented) --------------------------------------------------------
KEY_NAME = "workload.scenario.name"
KEY_SEED = "workload.seed"
KEY_THREADS = "workload.threads"
KEY_TARGET = "workload.target"
KEY_TARGET_HOST = "workload.target.host"
KEY_TARGET_PORT = "workload.target.port"
KEY_BOOTSTRAP = "workload.bootstrap"
KEY_TENANTS = "workload.tenants"
KEY_TENANTS_HOT = "workload.tenants.hot"
KEY_ZIPF_EXPONENT = "workload.tenants.zipf.exponent"
KEY_PAYLOAD_MEDIAN = "workload.payload.rows.median"
KEY_PAYLOAD_SIGMA = "workload.payload.rows.sigma"
KEY_PAYLOAD_MAX = "workload.payload.rows.max"
KEY_PHASES = "workload.phases"
KEY_OUT_DIR = "workload.out.dir"
KEY_TIMEOUT_SEC = "workload.request.timeout.sec"
KEY_WARMUP_REQUESTS = "workload.warmup.requests"
KEY_COMPILE_FLAT = "workload.slo.compile.flat"
KEY_FD_GROWTH_MAX = "workload.slo.fd.growth.max"
KEY_RSS_GROWTH_MAX_MB = "workload.slo.rss.growth.max.mb"
KEY_SOAK_CYCLES_MIN = "workload.soak.cycles.min"
KEY_FLEET_SNAPSHOT = "workload.fleet.snapshot"

DEFAULT_THREADS = 4
DEFAULT_TENANTS = 1
DEFAULT_TENANTS_HOT = 20
DEFAULT_ZIPF_EXPONENT = 1.5
DEFAULT_PAYLOAD_MEDIAN = 2
DEFAULT_PAYLOAD_SIGMA = 0.8
DEFAULT_PAYLOAD_MAX = 64
DEFAULT_TIMEOUT_SEC = 30.0
DEFAULT_WARMUP_REQUESTS = 32

TARGETS = ("serve", "stream")
BOOTSTRAPS = ("churn_nb", "tenant_fleet", "none")


def _phase_key(phase: str, suffix: str) -> str:
    """The per-phase derived key family ``workload.phase.<name>.<suffix>``
    (runtime-derived, like ``serve.model.<name>.*`` — see module doc)."""
    return f"workload.phase.{phase}.{suffix}"


class Envelope:
    """One phase's declared SLO ceilings.  ``None`` means the dimension
    is unconstrained for this phase."""

    __slots__ = ("p99_ms", "error_max_fraction", "shed_max_fraction",
                 "innocents_dropped_max", "deferred_max_fraction")

    def __init__(self, p99_ms: Optional[float],
                 error_max_fraction: Optional[float],
                 shed_max_fraction: Optional[float],
                 innocents_dropped_max: Optional[int],
                 deferred_max_fraction: Optional[float]):
        self.p99_ms = p99_ms
        self.error_max_fraction = error_max_fraction
        self.shed_max_fraction = shed_max_fraction
        self.innocents_dropped_max = innocents_dropped_max
        self.deferred_max_fraction = deferred_max_fraction


class PhaseSpec:
    """One named traffic phase: arrival process + chaos dials + SLO
    envelope, parsed from its ``workload.phase.<name>.*`` key family."""

    __slots__ = ("name", "arrival", "rate", "duration_s", "surge_factor",
                 "surge_start_s", "surge_duration_s", "period_s",
                 "amplitude", "poison_fraction", "feedback_fraction",
                 "feedback_dup_fraction", "feedback_reorder_fraction",
                 "feedback_lag_ms_max", "chaos", "envelope")

    def __init__(self, name: str, config: JobConfig):
        self.name = name

        def g(suffix: str, default=None):
            return config.get(_phase_key(name, suffix), default)

        def gf(suffix: str, default=None):
            v = g(suffix)
            return float(v) if v is not None else default

        self.arrival = g("arrival", "constant")
        self.rate = gf("rate")
        self.duration_s = gf("duration.sec")
        if self.rate is None or self.duration_s is None:
            raise KeyError(
                f"phase {name!r} needs workload.phase.{name}.rate and "
                f"workload.phase.{name}.duration.sec")
        self.surge_factor = gf("surge.factor", 10.0)
        self.surge_start_s = gf("surge.start.sec")
        self.surge_duration_s = gf("surge.duration.sec")
        self.period_s = gf("diurnal.period.sec")
        self.amplitude = gf("diurnal.amplitude", 0.5)
        self.poison_fraction = gf("poison.fraction", 0.0)
        # chaos phases expect EXTERNAL failure injection (a harness
        # killing a backend mid-phase); the flag arms the same
        # dropped-innocents accounting poison phases get, so the
        # envelope can declare "zero innocents dropped under the kill"
        self.chaos = config.get_boolean(_phase_key(name, "chaos"), False)
        self.feedback_fraction = gf("feedback.fraction", 0.0)
        self.feedback_dup_fraction = gf("feedback.dup.fraction", 0.0)
        self.feedback_reorder_fraction = gf("feedback.reorder.fraction", 0.0)
        self.feedback_lag_ms_max = gf("feedback.lag.ms.max", 0.0)
        inno = g("slo.innocents.dropped.max")
        self.envelope = Envelope(
            gf("slo.p99.ms"),
            gf("slo.error.max.fraction"),
            gf("slo.shed.max.fraction"),
            int(inno) if inno is not None else None,
            gf("slo.deferred.max.fraction"))


class Scenario:
    """A parsed scenario manifest: fleet shape + ordered phases."""

    __slots__ = ("name", "seed", "threads", "target", "target_host",
                 "target_port", "bootstrap", "tenants", "tenants_hot",
                 "zipf_exponent", "payload_median", "payload_sigma",
                 "payload_max", "phases", "out_dir", "timeout_s",
                 "warmup_requests", "compile_flat", "fd_growth_max",
                 "rss_growth_max_mb", "soak_cycles_min", "fleet_snapshot",
                 "config")

    def __init__(self, config: JobConfig):
        self.config = config
        self.name = config.must(KEY_NAME)
        self.seed = config.get_int(KEY_SEED, 0)
        self.threads = max(config.get_int(KEY_THREADS, DEFAULT_THREADS), 1)
        self.target = config.get(KEY_TARGET, "serve")
        if self.target not in TARGETS:
            raise ValueError(
                f"{KEY_TARGET} must be one of {TARGETS}, got "
                f"{self.target!r}")
        # external target: point the fleet at an ALREADY-RUNNING wire
        # endpoint (a fleet router, a remote serve process) instead of
        # building one in-process — port 0 means in-process (default)
        self.target_host = config.get(KEY_TARGET_HOST, "127.0.0.1")
        self.target_port = config.get_int(KEY_TARGET_PORT, 0)
        self.bootstrap = config.get(
            KEY_BOOTSTRAP,
            "churn_nb" if self.target == "serve" and not self.target_port
            else "none")
        if self.bootstrap not in BOOTSTRAPS:
            raise ValueError(
                f"{KEY_BOOTSTRAP} must be one of {BOOTSTRAPS}, got "
                f"{self.bootstrap!r}")
        self.tenants = config.get_int(KEY_TENANTS, DEFAULT_TENANTS)
        self.tenants_hot = config.get_int(KEY_TENANTS_HOT,
                                          DEFAULT_TENANTS_HOT)
        self.zipf_exponent = config.get_float(KEY_ZIPF_EXPONENT,
                                              DEFAULT_ZIPF_EXPONENT)
        self.payload_median = config.get_int(KEY_PAYLOAD_MEDIAN,
                                             DEFAULT_PAYLOAD_MEDIAN)
        self.payload_sigma = config.get_float(KEY_PAYLOAD_SIGMA,
                                              DEFAULT_PAYLOAD_SIGMA)
        self.payload_max = config.get_int(KEY_PAYLOAD_MAX,
                                          DEFAULT_PAYLOAD_MAX)
        names = config.must_list(KEY_PHASES)
        self.phases = [PhaseSpec(n.strip(), config) for n in names]
        self.out_dir = config.get(KEY_OUT_DIR, "workload-out")
        self.timeout_s = config.get_float(KEY_TIMEOUT_SEC,
                                          DEFAULT_TIMEOUT_SEC)
        self.warmup_requests = config.get_int(KEY_WARMUP_REQUESTS,
                                              DEFAULT_WARMUP_REQUESTS)
        self.compile_flat = config.get_boolean(KEY_COMPILE_FLAT, False)
        # run-level resource-leak gates (soak profiles): net fd-count /
        # RSS growth ceilings between the post-warmup baseline and run
        # end, and a promote/demote cycle FLOOR so a flatness verdict
        # cannot pass vacuously on a run that never actually churned
        self.fd_growth_max = config.get_int(KEY_FD_GROWTH_MAX)
        self.rss_growth_max_mb = config.get_float(KEY_RSS_GROWTH_MAX_MB)
        self.soak_cycles_min = config.get_int(KEY_SOAK_CYCLES_MIN)
        # fleet-snapshot mode: phase/final snapshots fold EVERY feed in
        # the fleetobs spool (this run publishes its own feed there),
        # not just the in-process exporter — the verdict then judges the
        # fleet, not one process
        self.fleet_snapshot = config.get_boolean(KEY_FLEET_SNAPSHOT, False)


# ---------------------------------------------------------------------------
# the schedule: manifest -> deterministic event list
# ---------------------------------------------------------------------------

def tenant_universe(scenario: Scenario) -> List[str]:
    """The ranked tenant id list traffic is drawn over.  ``stream``
    targets use the declared ``stream.tenants`` manifest (decide
    requests must name known tenants); ``tenant_fleet`` bootstraps use
    the synthetic ``seg%04d`` catalog the runner registers with the
    model cache; single-model serve scenarios have one pseudo-tenant —
    the served model itself."""
    if scenario.target == "stream":
        tenants = scenario.config.get_list(posterior.KEY_TENANTS)
        if not tenants:
            raise KeyError(
                "stream-target scenarios need stream.tenants declared in "
                "the manifest")
        return [t.strip() for t in tenants]
    if scenario.bootstrap == "tenant_fleet":
        return [f"seg{i:04d}" for i in range(max(scenario.tenants, 1))]
    return ["__single__"]       # replaced with the model name by the runner


def build_phase_events(scenario: Scenario, phase: PhaseSpec,
                       tenants: List[str], arms: List[str],
                       rng: random.Random) -> List[Event]:
    """One phase's events, time-sorted.  Draw order is fixed (arrivals,
    then per-arrival tenant/payload/fault draws in schedule order), so
    the stream of rng consumption — and therefore the bytes — is a pure
    function of (manifest, seed)."""
    offsets = gen.arrival_offsets(
        phase.arrival, phase.rate, phase.duration_s, rng,
        surge_factor=phase.surge_factor,
        surge_start_s=phase.surge_start_s,
        surge_duration_s=phase.surge_duration_s,
        period_s=phase.period_s,
        amplitude=phase.amplitude)
    sampler = (gen.ZipfSampler(len(tenants), scenario.zipf_exponent)
               if len(tenants) > 1 else None)
    events: List[Event] = []
    feedback: List[Event] = []
    for i, off in enumerate(offsets):
        tenant = tenants[sampler.draw(rng)] if sampler else tenants[0]
        ident = rng.randrange(1 << 30)
        if phase.poison_fraction and rng.random() < phase.poison_fraction:
            events.append(Event(phase.name, off, "predict", tenant,
                                [gen.poison_row(rng, ident)], poison=True))
            continue
        if scenario.target == "stream":
            events.append(Event(phase.name, off, "decide", tenant,
                                [f"e{ident:08x},{tenant}"]))
            if (phase.feedback_fraction
                    and rng.random() < phase.feedback_fraction):
                arm = arms[rng.randrange(len(arms))]
                reward = rng.randrange(2)
                lag = (rng.random() * phase.feedback_lag_ms_max / 1000.0
                       if phase.feedback_lag_ms_max else 0.0)
                fault = gen.feedback_fault(
                    rng, phase.feedback_dup_fraction,
                    phase.feedback_reorder_fraction)
                fb = Event(phase.name, off + lag, "feedback", tenant,
                           [f"{tenant},{arm},{reward}"], fault=fault)
                feedback.append(fb)
                if fault == "dup":
                    feedback.append(Event(phase.name, off + lag, "feedback",
                                          tenant, list(fb.rows),
                                          fault="dup"))
            continue
        n_rows = gen.payload_rows(rng, scenario.payload_median,
                                  scenario.payload_sigma,
                                  scenario.payload_max)
        rows = [gen.churn_row(rng, (ident + j) % (1 << 30))
                for j in range(n_rows)]
        events.append(Event(phase.name, off, "predict", tenant, rows))
    # reorder chaos: swap each tagged feedback event's offset with its
    # successor — the consumer sees the later event first
    for i, fb in enumerate(feedback[:-1]):
        if fb.fault == "reorder":
            fb.offset_s, feedback[i + 1].offset_s = (
                feedback[i + 1].offset_s, fb.offset_s)
    events.extend(feedback)
    events.sort(key=lambda e: (e.offset_s, e.kind, e.tenant))
    return events


def build_schedule(scenario: Scenario,
                   tenants: Optional[List[str]] = None) -> List[Event]:
    """The full deterministic schedule: every phase's events (offsets
    are phase-relative; phases execute sequentially).  Thread count is
    deliberately NOT an input — partitioning happens later
    (:func:`generators.partition`), so replay is fleet-shape-invariant."""
    tenants = tenants if tenants is not None else tenant_universe(scenario)
    arms = [a.strip()
            for a in (scenario.config.get_list(posterior.KEY_ARMS)
                      or ["arm0"])]
    rng = random.Random(scenario.seed)
    events: List[Event] = []
    for phase in scenario.phases:
        events.extend(
            build_phase_events(scenario, phase, tenants, arms, rng))
    return events
