"""Scenario runner: ``python -m avenir_tpu_torch workload``.

One command runs one scenario end-to-end, its bootstrap training and its
in-process target on ``cuda:0`` unless ``--device cpu`` asks for the CPU
(without a card and without ``--device cpu`` it fails, as every entry
point does):

1. parse the manifest (``workload.*`` + any ``serve.*``/``stream.*``
   keys riding in the same file);
2. bootstrap the system under test in-process — train the Naive Bayes
   artifact for ``serve`` targets (``workload.bootstrap=churn_nb``),
   register a cold tenant catalog against the managed model cache
   (``tenant_fleet``), or compose the streaming decision service;
3. build the deterministic event schedule, warm the target, then drive
   each phase with the open-loop fleet;
4. emit the run's three artifacts into ``workload.out.dir``:
   ``telemetry.json`` (ONE merged snapshot: server registry + overlay
   merged with the fleet's client-side registry via
   ``telemetry.merge_snapshots``), ``trace.json`` (one connected
   Chrome/Perfetto trace — server spans and fleet phase spans share the
   in-process tracer), and ``verdict.json`` (atomic; the SLO-envelope
   judgment);
5. with ``--assert``, exit nonzero on any envelope violation, naming
   the violating phase and leaving exactly one
   ``flight-workload-<scenario>`` black-box dump behind.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core import flight, obs, telemetry
from ..core.config import JobConfig, parse_cli_args, parse_properties
from ..core.io import atomic_write_text, write_output
from . import scenario as scn
from .driver import Fleet, PhaseStats
from .generators import churn_row
from .scenario import Scenario, build_schedule, tenant_universe
from .verdict import dump_violation, evaluate_run, write_verdict

#: the bootstrap-trained model's schema (same field extents as
#: resource/serving/teleComChurn.json — generators.churn_row emits rows
#: inside these ranges)
CHURN_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "plan", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["planA", "planB"]},
    {"name": "minUsed", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 2200, "bucketWidth": 200},
    {"name": "dataUsed", "ordinal": 3, "dataType": "int", "feature": True,
     "min": 0, "max": 1000, "bucketWidth": 100},
    {"name": "csCall", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 0, "max": 14, "bucketWidth": 2},
    {"name": "csEmail", "ordinal": 5, "dataType": "int", "feature": True,
     "min": 0, "max": 22, "bucketWidth": 4},
    {"name": "network", "ordinal": 6, "dataType": "int", "feature": True},
    {"name": "churned", "ordinal": 7, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}

BOOTSTRAP_MODEL = "churn"
BOOTSTRAP_TRAIN_ROWS = 1200


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# bootstrap: build the system under test from the manifest
# ---------------------------------------------------------------------------

def _train_artifact(scenario: Scenario, boot_dir: str,
                    device=None) -> Tuple[str, str]:
    """Train the shared Naive Bayes artifact once per out dir on
    ``device``; returns (schema path, model path).  Reuses an existing
    artifact so repeated scenario runs (and the CI smoke) skip the
    training leg."""
    from ..datagen import gen_telecom_churn
    from ..models.bayesian import BayesianDistribution

    schema_path = os.path.join(boot_dir, "teleComChurn.json")
    model_path = os.path.join(boot_dir, "nb_model")
    if not os.path.exists(os.path.join(model_path, "_SUCCESS")):
        os.makedirs(boot_dir, exist_ok=True)
        atomic_write_text(schema_path, json.dumps(CHURN_SCHEMA))
        train_dir = os.path.join(boot_dir, "train")
        rows = gen_telecom_churn(BOOTSTRAP_TRAIN_ROWS, seed=scenario.seed)
        write_output(train_dir, [",".join(r) for r in rows])
        BayesianDistribution(JobConfig(
            {"feature.schema.file.path": schema_path}),
            device=device).run(train_dir, model_path)
    return schema_path, model_path


def bootstrap_target(scenario: Scenario, tenants: List[str],
                     device=None) -> Dict[str, str]:
    """Mutate the scenario config so the target can be constructed, and
    return the tenant -> served-model-name map the fleet addresses
    requests with."""
    config = scenario.config
    if scenario.target == "stream":
        # StreamDecisionService auto-declares the banditDecision model
        # from the stream.* manifest; every tenant decides against it
        from ..stream.service import DEFAULT_MODEL_NAME, KEY_MODEL_NAME
        name = config.get(KEY_MODEL_NAME, DEFAULT_MODEL_NAME)
        return {t: name for t in tenants}
    if scenario.bootstrap == "none":
        model = (config.get_list("serve.models") or [tenants[0]])[0].strip()
        return {t: model for t in tenants}
    boot_dir = os.path.join(scenario.out_dir, "bootstrap")
    schema_path, model_path = _train_artifact(scenario, boot_dir, device)
    if scenario.bootstrap == "churn_nb":
        config.set("serve.models", BOOTSTRAP_MODEL)
        config.set(f"serve.model.{BOOTSTRAP_MODEL}.kind", "naiveBayes")
        config.set(f"serve.model.{BOOTSTRAP_MODEL}."
                   f"feature.schema.file.path", schema_path)
        config.set(f"serve.model.{BOOTSTRAP_MODEL}."
                   f"bayesian.model.file.path", model_path)
        return {t: BOOTSTRAP_MODEL for t in tenants}
    # tenant_fleet: N cold tenants sharing one artifact behind the
    # device-memory-budget-aware cache (the manifest carries
    # the serve.cache.* budget/quota dials)
    conf_path = os.path.join(boot_dir, "tenant.properties")
    atomic_write_text(conf_path,
                      f"feature.schema.file.path={schema_path}\n"
                      f"bayesian.model.file.path={model_path}\n")
    config.set("serve.cache.models", ",".join(tenants))
    for t in tenants:
        config.set(f"serve.model.{t}.kind", "naiveBayes")
        config.set(f"serve.model.{t}.conf", conf_path)
    return {t: t for t in tenants}


def build_target(scenario: Scenario, device=None):
    """Construct + start the in-process system under test on ``device``;
    returns (stop fn, host, port, telemetry exporter, stats fn)."""
    config = scenario.config
    if scenario.target_port:
        # external target: the system under test is already running
        # (e.g. a fleet router fronting N backends) — nothing to build,
        # nothing to stop; stats go over the wire like any client, and
        # a local exporter still collects THIS process's driver-side
        # registry for the snapshot merge
        from ..serve.server import request
        host, port = scenario.target_host, scenario.target_port
        exporter = telemetry.TelemetryExporter(0.0)

        def stats_fn():
            return request(host, port, {"cmd": "stats"},
                           timeout=scenario.timeout_s)

        return ((lambda: None), host, port, exporter, stats_fn)
    if config.get("serve.port") is None:
        config.set("serve.port", "0")
    host = config.get("serve.host", "127.0.0.1")
    if scenario.target == "stream":
        from ..core import checkpoint
        from ..stream.service import StreamDecisionService
        # keep the feedback consumer's offset sidecar inside the
        # scenario's out dir (the service defaults to cwd)
        if config.get(checkpoint.KEY_PATH) is None:
            config.set(checkpoint.KEY_PATH,
                       os.path.join(scenario.out_dir, "stream.ckpt"))
        service = StreamDecisionService(config, device=device)
        port = service.start()
        return (service.stop, host, port, service.server.telemetry,
                service.server._stats)
    from ..serve.server import PredictionServer
    server = PredictionServer(config, device=device)
    port = server.start()
    return ((lambda: server.stop(drain=True)), host, port,
            server.telemetry, server._stats)


# ---------------------------------------------------------------------------
# run accounting
# ---------------------------------------------------------------------------

def run_snapshot(scenario: Scenario, exporter, fleet,
                 publisher=None) -> Tuple[dict, Optional[List[str]]]:
    """One merged run snapshot; returns (snapshot, contributing feeds).

    Default: the in-process exporter's registry+overlay merged with the
    fleet driver's client-side registry — one process's truth.  With
    ``workload.fleet.snapshot=true`` the run publishes its own snapshot
    into the fleetobs spool first, then folds EVERY feed's latest
    snapshot (this process plus any sibling publishers pointed at the
    same ``fleetobs.spool.dir``) and merges the client registry on top,
    so the artifacts judge the fleet, not one process."""
    local = exporter.snapshot()
    client = fleet.metrics.mergeable_snapshot()
    if publisher is None:
        return telemetry.merge_snapshots(local, client), None
    from ..fleetobs import fleet_fold
    from ..fleetobs import publisher as pub
    from ..fleetobs import stitch
    publisher.publish(local)
    feeds: Dict[str, dict] = {}
    for d in stitch.feed_dirs(scenario.config.get(pub.KEY_SPOOL_DIR)):
        try:
            with open(os.path.join(d, pub.SNAPSHOT_FILE), "r") as fh:
                feeds[os.path.basename(d)] = json.load(fh)["snapshot"]
        except (OSError, ValueError, KeyError):
            continue        # a feed mid-first-publish folds next time
    return (telemetry.merge_snapshots(fleet_fold(feeds), client),
            sorted(feeds))


def compile_count(stats: dict) -> int:
    """Total scorer compilations visible in a ``stats`` response.

    With the shared compile tier active (model-cache mode) the tier's
    cumulative count IS the fleet-wide series — per-model ``Serve /
    Scorer compilations`` bill the same tier compiles to the model that
    caused them, and an evicted model takes its counter out of the stats
    surface, so summing both would double-count real compiles and read
    eviction/re-promote churn as compile movement.  Without the tier,
    the per-model counters are the only (and complete) source."""
    tier = ((stats.get("cache") or {}).get("compile_tier") or {})
    if "compiles" in tier:
        return tier["compiles"]
    total = 0
    for m in (stats.get("models") or {}).values():
        total += ((m.get("counters") or {}).get("Serve") or {}).get(
            "Scorer compilations", 0)
    return total


def process_usage() -> dict:
    """This process's resource footprint for the soak gates:
    ``{"fds": open-fd count, "rss_mb": resident set in MB}``, each None
    where the platform offers no ``/proc/self`` view (the verdict then
    fails a DECLARED gate loudly instead of passing it vacuously)."""
    fds = None
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    rss_mb = None
    try:
        with open("/proc/self/statm", "r") as fh:
            pages = int(fh.read().split()[1])
        rss_mb = pages * (os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0))
    except (OSError, ValueError, IndexError):
        pass
    return {"fds": fds, "rss_mb": rss_mb}


def demote_cycles(stats: dict) -> int:
    """Cumulative promote/demote cycles visible in a ``stats``
    response.  A residency cycle a completed promote opened closes one
    of two ways — LRU eviction by a later promote (``Evictions``) or an
    operator demote (``Demotes``) — so the cycle count is their sum.
    Zero without the cache — single-model targets have no residency
    churn to count."""
    c = ((stats.get("cache") or {}).get("counters") or {})
    return c.get("Evictions", 0) + c.get("Demotes", 0)


def _warmup(scenario: Scenario, fleet: Fleet, tenants: List[str]) -> None:
    """Pre-phase warmup (uncounted): touch the hot head of the tenant
    ranking so steady-state phases measure serving, not first-compile —
    the compile-flat gate snapshots its baseline AFTER this."""
    import random as _random
    from ..serve.server import request

    rng = _random.Random(scenario.seed ^ 0xBEEF)
    n = max(scenario.warmup_requests, 0)
    hot = tenants[:max(min(scenario.tenants_hot, len(tenants)), 1)]
    for i in range(n):
        tenant = hot[i % len(hot)]
        model = fleet.model_for.get(tenant, tenant)
        if scenario.target == "stream":
            obj = {"model": model, "decide": f"warm{i:06d},{tenant}"}
        else:
            obj = {"model": model, "row": churn_row(rng, i)}
        try:
            request(fleet.host, fleet.port, obj,
                    timeout=scenario.timeout_s)
        except OSError:
            pass        # warmup is best-effort; phases will measure it


def _quiesce_compiles(stats_fn: Callable[[], dict],
                      settle_s: float = 0.25,
                      deadline_s: float = 10.0) -> int:
    """Wait for the post-warmup compile count to stop moving and return
    it.  Model-cache promotion warms scorer buckets on ASYNC worker
    threads — a baseline snapshotted while a promote is still warming
    would bill that warmup's final compile to the run and fail the
    compile-flat gate on a race, not a regression."""
    t_end = time.monotonic() + deadline_s
    last = compile_count(stats_fn())
    while time.monotonic() < t_end:
        time.sleep(settle_s)
        now = compile_count(stats_fn())
        if now == last:
            return now
        last = now
    return last


def run_scenario(config: JobConfig, do_assert: bool = False,
                 log: Callable[[str], None] = _log, device=None) -> int:
    """Execute one scenario on ``device``; returns the process exit
    code."""
    scenario = Scenario(config)
    os.makedirs(scenario.out_dir, exist_ok=True)
    publisher = None
    if scenario.fleet_snapshot:
        # validated before any bootstrap work: fleet mode without a
        # spool is a manifest error, not a mid-run surprise
        from ..fleetobs.publisher import KEY_SPOOL_DIR, publisher_for_job
        publisher = publisher_for_job(config, role="workload")
        if publisher is None:
            raise KeyError(
                f"{scn.KEY_FLEET_SNAPSHOT}=true needs {KEY_SPOOL_DIR} "
                f"naming the fleet spool this run publishes into")
    tenants = tenant_universe(scenario)
    model_for = bootstrap_target(scenario, tenants, device)
    schedule = build_schedule(scenario, tenants)
    stop, host, port, exporter, stats_fn = build_target(scenario, device)
    if publisher is not None:
        publisher.attach(exporter)
    per_phase: Dict[str, PhaseStats] = {}
    phase_snapshots: Dict[str, dict] = {}
    fleet = Fleet(host, port, scenario.threads, scenario.timeout_s,
                  model_for=model_for)
    trace_path = os.path.join(scenario.out_dir, "trace.json")
    try:
        log(f"workload {scenario.name!r}: target={scenario.target} "
            f"on {host}:{port}, {len(tenants)} tenants, "
            f"{len(schedule)} scheduled events, "
            f"{scenario.threads} client threads, seed={scenario.seed}")
        _warmup(scenario, fleet, tenants)
        compiles0 = _quiesce_compiles(stats_fn)
        usage0 = process_usage()
        cycles0 = demote_cycles(stats_fn())
        for spec in scenario.phases:
            events = [e for e in schedule if e.phase == spec.name]
            stats = fleet.run_phase(
                spec.name, events,
                poison_phase=spec.poison_fraction > 0 or spec.chaos)
            per_phase[spec.name] = stats
            phase_snapshots[spec.name], _ = run_snapshot(
                scenario, exporter, fleet, publisher)
            s = stats.summary()
            log(f"  phase {spec.name!r}: {s['sent']} sent @ "
                f"{s['achieved_rps']}/s, p99 {s['p99_ms']} ms, "
                f"outcomes {s['outcomes']}")
        final_stats = stats_fn()
        compiles1 = compile_count(final_stats)
        cycles1 = demote_cycles(final_stats)
        usage1 = process_usage()
        if scenario.soak_cycles_min is not None:
            log(f"  soak: {cycles1 - cycles0} promote/demote cycles, "
                f"fd {usage0['fds']} -> {usage1['fds']}, "
                f"rss {usage0['rss_mb'] and round(usage0['rss_mb'], 1)}"
                f" -> {usage1['rss_mb'] and round(usage1['rss_mb'], 1)}"
                f" MB")
    finally:
        stop()
        n = obs.get_tracer().export_chrome_trace(trace_path)
        log(f"  trace: {n} events -> {trace_path}")

    merged, fold_feeds = run_snapshot(scenario, exporter, fleet, publisher)
    telemetry_path = os.path.join(scenario.out_dir, "telemetry.json")
    atomic_write_text(telemetry_path, json.dumps(merged) + "\n")
    log(f"  telemetry: merged snapshot -> {telemetry_path}"
        + (f" (fleet fold over {len(fold_feeds)} feeds)"
           if fold_feeds is not None else ""))

    verdict = evaluate_run(scenario, per_phase,
                           compiles_after_warmup=compiles0,
                           compiles_at_end=compiles1,
                           usage_after_warmup=usage0,
                           usage_at_end=usage1,
                           cycles_after_warmup=cycles0,
                           cycles_at_end=cycles1)
    if fold_feeds is not None:
        # the verdict names its evidence: which spool feeds the judged
        # snapshots folded (the run's own feed plus any siblings)
        verdict["fleet"] = {"feeds": fold_feeds,
                            "source": "fleetobs-spool"}
    verdict_path = os.path.join(scenario.out_dir, "verdict.json")
    write_verdict(verdict_path, verdict)
    log(f"  verdict: {'PASS' if verdict['pass'] else 'FAIL'} "
        f"-> {verdict_path}")
    if verdict["pass"]:
        return 0
    first = verdict["violations"][0]
    log(f"workload {scenario.name!r}: envelope VIOLATED in phase "
        f"{first['phase']!r}: {first['key']} = {first['actual']} "
        f"(limit {first['limit']})"
        + "".join(f"\n  also: phase {v['phase']!r} {v['key']} = "
                  f"{v['actual']} (limit {v['limit']})"
                  for v in verdict["violations"][1:]))
    if not do_assert:
        return 0
    dump = dump_violation(scenario, verdict, per_phase,
                          phase_snapshots.get(first["phase"]))
    if dump:
        log(f"  flight: black-box dump -> {dump}")
    return 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def workload_main(argv) -> int:
    """``python -m avenir_tpu_torch workload --scenario <file.properties>
    [--assert] [--device cpu|cuda] [-Dkey=value ...]``."""
    from ..cli import (_extract_value_flag, configure_resilience,
                       extract_device_flag)

    argv = list(argv)
    if argv and argv[0] in ("-h", "--help"):
        print("usage: python -m avenir_tpu_torch workload --scenario "
              "<scenario.properties> [--assert] [--device cpu|cuda] "
              "[-Dkey=value ...]", file=sys.stderr)
        return 2
    argv, device = extract_device_flag(argv)
    argv, scenario_path = _extract_value_flag(argv, "--scenario")
    do_assert = "--assert" in argv
    argv = [a for a in argv if a != "--assert"]
    defines, positional = parse_cli_args(argv)
    if scenario_path is None or positional:
        print("workload: expected --scenario <scenario.properties> "
              "[--assert] [--device cpu|cuda] [-Dkey=value ...]",
              file=sys.stderr)
        return 2
    with open(scenario_path, "r") as fh:
        config = JobConfig(parse_properties(fh.read()))
    for k, v in defines.items():
        config.set(k, v)
    # the verdict's flight dump lands next to the run's artifacts unless
    # the manifest routes it elsewhere
    if config.get(flight.KEY_DUMP_DIR) is None:
        config.set(flight.KEY_DUMP_DIR,
                   config.get(scn.KEY_OUT_DIR, "workload-out"))
    os.makedirs(config.get(scn.KEY_OUT_DIR, "workload-out"), exist_ok=True)
    # the run always exports its trace artifact, so tracing is on
    # regardless of obs.trace.enable (same force as --trace elsewhere)
    obs.configure_from_config(config, force_enable=True)
    configure_resilience(config)
    telemetry.configure_from_config(config)
    t0 = time.monotonic()
    try:
        rc = run_scenario(config, do_assert=do_assert, device=device)
    except BaseException as exc:
        flight.fatal(exc)
        raise
    _log(f"workload: done in {time.monotonic() - t0:.1f}s (exit {rc})")
    return rc
