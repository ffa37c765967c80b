"""Job driver: ``python -m avenir_tpu_torch <Job|FQCN> -Dconf.path=<props>
<in> <out> [--device cpu|cuda] [--resume] [--trace <out.json>]
[--profile-dir=<dir>]``; the shared scan: ``python -m avenir_tpu_torch
multi -Dconf.path=<manifest> <in> [<out>] [--device cpu|cuda] [--resume]
[--trace <out.json>] [--metrics-out <series.jsonl>] [--profile-dir=<dir>]``
(core.multiscan); the workflow DAG: ``python -m avenir_tpu_torch dag
-Dconf.path=<workflow.properties> <in> [<out>]`` with the same flags
(core.dag); the prediction server: ``python -m avenir_tpu_torch
serve -Dconf.path=<serve.properties> [--device cpu|cuda] [--trace
<out.json>] [--metrics-out <series.jsonl>]`` (serve.server); and the
streaming decision service: ``python -m avenir_tpu_torch stream
-Dconf.path=<stream.properties> [--device cpu|cuda] [--resume] [--trace
<out.json>] [--metrics-out <series.jsonl>]`` (stream.service); the
workload harness: ``python -m avenir_tpu_torch workload --scenario
<scenario.properties> [--assert] [--device cpu|cuda]`` (workload.runner);
the fleet observability aggregator: ``python -m avenir_tpu_torch fleetobs
-Dfleetobs.spool.dir=<dir>`` or ``fleetobs stitch --spool <dir>``
(fleetobs.aggregator); and the fleet router: ``python -m
avenir_tpu_torch router -Drouter.backends=host:p1,host:p2``
(serve.fleet.router).  ``router`` and ``fleetobs`` move bytes and read
feeds: they import no torch and refuse ``--device``.  The static
analysis of the package's own source: ``python -m avenir_tpu_torch
analyze [--strict] [--json report.json] [--rules a,b] [--list]
[--no-cache] [--baseline findings.json] [--update-baseline] [--dynamic]
[--seeds N] [--device cpu|cuda]`` (analysis.cli; ``--dynamic`` runs the
fold certificate on ``cuda:0`` unless ``--device cpu``).

The same invocation, ``.properties`` files, schema JSONs and in/out
directory layout as the reference package's ``python -m avenir_tpu``; job
counters print to stderr.  Jobs run on ``cuda:0`` unless ``--device cpu``
asks for the CPU, and fail when there is no card.  A job whose ``run``
returns a status instead of counters (``LogisticRegressionJob``: 100
converged, 101 not yet) exits with it, as the reference's driver does.

``multi`` runs every job of a ``multi.jobs`` manifest off one streamed
scan of the input, each writing its normal output file; jobs that cannot
fuse run standalone after it.  ``--profile-dir=<dir>`` records the whole
job (or ``multi`` run) with ``torch.profiler`` and writes its Chrome trace
into ``<dir>``.

``AVENIR_MESH=<data>x<model>`` runs a job (its ``run(..., mesh=)``),
``multi``, ``dag`` and ``serve`` on ``parallel.mesh.get_mesh()``, as the
reference's jobs do: on a card, a data x model grid over every visible
card (data x model must equal their count); with ``--device cpu``, the
CPU named data x model times (the counterpart of the reference's virtual
host devices; every position computes on the one CPU).  Unset, a host
with several cards runs them on every card along the data axis, the
reference's default mesh, unless ``--device cuda:N`` or ``--device cpu``
names one device; on one card they run on it alone.

``--resume`` sets ``checkpoint.resume=true``: a streaming job restarts
from its sidecar checkpoint when one exists (core.checkpoint).
``--trace <out.json>`` turns the tracer on and writes its spans as
Chrome/Perfetto trace JSON when the job ends (core.obs).  Before the job
is built, the resilience keys are applied: ``sanitize.locks``
(core.sanitizer), ``retry.*`` (core.resilience), ``fault.inject.plan``
(core.faultinject), ``io.require.success`` (core.io) and ``flight.*``
(core.flight).
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import os
import sys
from typing import Callable, Dict, Optional

from .core.config import load_job_config, parse_cli_args
from .core.metrics import Counters

# reference driver class -> (module under models, job class, config prefix)
JOBS: Dict[str, tuple] = {
    "org.avenir.bayesian.BayesianDistribution":
        ("bayesian", "BayesianDistribution", ""),
    "org.avenir.bayesian.BayesianPredictor":
        ("bayesian", "BayesianPredictor", "bp"),
    "org.sifarish.feature.SameTypeSimilarity":
        ("knn", "SameTypeSimilarity", ""),
    "org.avenir.knn.FeatureCondProbJoiner":
        ("knn", "FeatureCondProbJoiner", ""),
    "org.avenir.knn.NearestNeighbor": ("knn", "NearestNeighbor", ""),
    "org.avenir.cluster.AgglomerativeGraphical":
        ("cluster", "AgglomerativeGraphical", ""),
    "org.avenir.markov.MarkovStateTransitionModel":
        ("markov", "MarkovStateTransitionModel", "mst"),
    "org.avenir.markov.MarkovModelClassifier":
        ("markov", "MarkovModelClassifier", ""),
    "org.avenir.markov.HiddenMarkovModelBuilder":
        ("markov", "HiddenMarkovModelBuilder", ""),
    "org.avenir.markov.ViterbiStatePredictor":
        ("markov", "ViterbiStatePredictor", ""),
    "org.avenir.association.FrequentItemsApriori":
        ("association", "FrequentItemsApriori", "fia"),
    "org.avenir.association.AssociationRuleMiner":
        ("association", "AssociationRuleMiner", "arm"),
    "org.avenir.association.InfrequentItemMarker":
        ("association", "InfrequentItemMarker", "iim"),
    "org.avenir.markov.ProbabilisticSuffixTreeGenerator":
        ("pst", "ProbabilisticSuffixTreeGenerator", ""),
    "org.avenir.explore.MutualInformation":
        ("mutual_info", "MutualInformation", ""),
    "org.avenir.explore.CramerCorrelation":
        ("correlation", "CramerCorrelation", ""),
    "org.avenir.explore.HeterogeneityReductionCorrelation":
        ("correlation", "HeterogeneityReductionCorrelation", ""),
    "org.avenir.explore.NumericalCorrelation":
        ("correlation", "NumericalCorrelation", "nco"),
    "org.avenir.discriminant.FisherDiscriminant":
        ("discriminant", "FisherDiscriminant", ""),
    "org.chombo.mr.NumericalAttrStats":
        ("discriminant", "NumericalAttrStats", ""),
    "org.avenir.explore.ClassPartitionGenerator":
        ("tree", "ClassPartitionGenerator", ""),
    "org.avenir.tree.SplitGenerator": ("tree", "SplitGenerator", ""),
    "org.avenir.tree.DecisionTreeBuilder":
        ("tree", "DecisionTreeBuilder", "dtb"),
    "org.avenir.tree.DataPartitioner": ("tree", "DataPartitioner", ""),
    "org.avenir.text.WordCounter": ("text", "WordCounter", ""),
    "org.avenir.regress.LogisticRegressionJob":
        ("regress", "LogisticRegressionJob", ""),
    "org.avenir.explore.BaggingSampler": ("sampler", "BaggingSampler", ""),
    "org.avenir.explore.UnderSamplingBalancer":
        ("sampler", "UnderSamplingBalancer", ""),
    "org.avenir.sequence.CandidateGenerationWithSelfJoin":
        ("sequence", "CandidateGenerationWithSelfJoin", "cgs"),
    "org.avenir.sequence.SequencePositionalCluster":
        ("sequence", "SequencePositionalCluster", ""),
    "org.avenir.reinforce.GreedyRandomBandit":
        ("bandit", "GreedyRandomBandit", ""),
    "org.avenir.reinforce.AuerDeterministic":
        ("bandit", "AuerDeterministic", ""),
    "org.avenir.reinforce.SoftMaxBandit": ("bandit", "SoftMaxBandit", ""),
    "org.avenir.reinforce.RandomFirstGreedyBandit":
        ("bandit", "RandomFirstGreedyBandit", ""),
    # the batch replay of a reward-event log (no reference Java class)
    "org.avenir.reinforce.BanditFeedbackAggregator":
        ("bandit", "BanditFeedbackAggregator", ""),
    # the chombo legs that the runbooks run between avenir jobs
    "org.chombo.mr.TemporalFilter": ("chombo", "TemporalFilter", "tef"),
    "org.chombo.mr.Projection": ("chombo", "Projection", ""),
    "org.chombo.mr.RunningAggregator": ("chombo", "RunningAggregator", ""),
    # the streaming loop; positional args are (topologyName, configFile)
    # as the reference's main() (ReinforcementLearnerTopology.java:42-47)
    "org.avenir.reinforce.ReinforcementLearnerTopology":
        ("streaming", "ReinforcementLearnerTopology", ""),
}


def resolve(name: str) -> tuple:
    if name in JOBS:
        return JOBS[name]
    for fq, spec in JOBS.items():
        if fq.rsplit(".", 1)[1] == name:
            return spec
    raise SystemExit(f"unknown job: {name}\nknown jobs:\n  "
                     + "\n  ".join(sorted(JOBS)))


def register(fqcn: str, module: str, cls: str, prefix: str = "") -> None:
    """Add a job to ``JOBS``: ``cls`` in ``models.<module>``, its config
    keys under ``prefix``."""
    JOBS[fqcn] = (module, cls, prefix)


def job_class(name: str):
    """The job class registered under ``name`` (short or FQCN)."""
    module, clsname, _ = resolve(name)
    mod = importlib.import_module(f"{__package__}.models.{module}")
    return getattr(mod, clsname)


def job_resolver(device=None) -> Callable:
    """The ``multi`` and ``dag`` manifests' resolver: a job class name ->
    (factory, prefix), the factory building the job on ``device``.  The
    factory carries the class as ``job_class`` (core.dag probes it for a
    ``fold_spec`` without building the job) and the resolver its
    ``device`` (the DAG's built-in stages are built on it)."""
    def resolver(cls_name: str):
        cls = job_class(cls_name)

        def factory(config):
            return cls(config, device=device)
        factory.job_class = cls
        return factory, resolve(cls_name)[2]
    resolver.device = device
    return resolver


def cli_mesh(device=None):
    """The mesh a command runs on, ``parallel.mesh.get_mesh(device)``:
    the ``AVENIR_MESH`` grid when it is set; unset, every visible card on
    the data axis when ``--device`` names no one device (absent, or
    ``cuda`` without an index) and more than one card is visible, as the
    reference's default mesh.  None otherwise (one card, ``cuda:N``,
    ``cpu``): the command runs on the one device of ``--device``."""
    from .parallel.mesh import every_card, get_mesh
    if not os.environ.get("AVENIR_MESH"):
        import torch
        if not (every_card(device) and torch.cuda.is_available()
                and torch.cuda.device_count() > 1):
            return None
    return get_mesh(device)


def run_mesh(device=None):
    """``multi``'s and ``dag``'s mesh: ``cli_mesh`` where it gives one,
    else the one device of ``--device``."""
    from .device import resolve_device
    from .parallel.mesh import make_mesh
    return cli_mesh(device) or make_mesh([resolve_device(device)])


def extract_device_flag(argv):
    """Pull ``--device X`` / ``--device=X`` out of an argument vector;
    returns (remaining argv, device or None)."""
    out, device, i = [], None, 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device requires a value (cpu or cuda)")
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.partition("=")[2]
        else:
            out.append(a)
        i += 1
    return out, device


def _extract_value_flag(argv, flag: str):
    """Pull ``flag <value>`` / ``flag=<value>`` out of an argument
    vector; returns (remaining argv, value or None)."""
    out, value, i = [], None, 0
    while i < len(argv):
        a = argv[i]
        if a == flag:
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} requires an output path")
            value = argv[i + 1]
            i += 2
            continue
        if a.startswith(flag + "="):
            value = a.partition("=")[2]
            if not value:
                raise SystemExit(f"{flag} requires an output path")
        else:
            out.append(a)
        i += 1
    return out, value


def extract_trace_flag(argv):
    """Pull ``--trace <out.json>`` out of an argument vector."""
    return _extract_value_flag(argv, "--trace")


def extract_metrics_out_flag(argv):
    """Pull ``--metrics-out <path>`` out of an argument vector: the path
    of the periodic telemetry exporter's JSONL series (core.telemetry)."""
    return _extract_value_flag(argv, "--metrics-out")


def extract_profile_dir_flag(argv):
    """Pull ``--profile-dir=<dir>`` out of an argument vector; returns
    (remaining argv, dir or None).  The space-separated form is refused,
    as the reference refuses it."""
    out, value = [], None
    for a in argv:
        if a == "--profile-dir" or a.startswith("--profile-dir="):
            value = a.partition("=")[2]
            if not value:
                raise SystemExit("--profile-dir requires --profile-dir=<dir> "
                                 "(the space-separated form is not "
                                 "supported)")
        else:
            out.append(a)
    return out, value


@contextlib.contextmanager
def profiled(profile_dir: Optional[str]):
    """Record the enclosed work with ``torch.profiler`` (the CPU, and the
    card when there is one) and write its Chrome trace to
    ``<profile_dir>/trace-<pid>.json``, also when the work raises.  Does
    nothing without a directory."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        print(f"profile: wrote {path}", file=sys.stderr)


def extract_resume_flag(argv):
    """Pull ``--resume`` out of an argument vector; returns (remaining
    argv, bool)."""
    out = [a for a in argv if a != "--resume"]
    return out, len(out) != len(argv)


def configure_resilience(config) -> None:
    """Apply the resilience config surfaces of ``config`` to this process
    (lock sanitizer, retry policy, fault plan, the io durability strict
    mode, the flight recorder) before any engine or server is built, so
    ``sanitize.locks=true`` catches every lock."""
    from .core import faultinject, flight, io, resilience, sanitizer
    sanitizer.configure_from_config(config)
    resilience.configure_from_config(config)
    faultinject.configure_from_config(config)
    io.configure_from_config(config)
    flight.configure_from_config(config)


def _export_trace(trace_path: Optional[str]) -> None:
    if not trace_path:
        return
    from .core import obs
    n = obs.get_tracer().export_chrome_trace(trace_path)
    print(f"obs: wrote {n} trace events to {trace_path}", file=sys.stderr)


def multi_main(argv) -> int:
    """``python -m avenir_tpu_torch multi -Dconf.path=<manifest> <in>
    [<out>]``: every job of the ``multi.jobs`` manifest off one streamed
    scan (core.multiscan), each writing its normal output file, on
    ``cuda:0`` unless ``--device cpu``.  Jobs that cannot fuse (no
    FoldSpec, a mid-stream withdrawal) run standalone after the fused
    pass, so the workflow's outputs are always complete."""
    argv, device = extract_device_flag(argv)
    argv, trace_path = extract_trace_flag(argv)
    argv, metrics_out = extract_metrics_out_flag(argv)
    argv, resume = extract_resume_flag(argv)
    argv, profile_dir = extract_profile_dir_flag(argv)
    defines, positional = parse_cli_args(argv)
    if not positional:
        print("expected <input path> [<output base dir>]", file=sys.stderr)
        return 2
    in_path = positional[0]
    out_base = positional[1] if len(positional) > 1 else None

    config = load_job_config(defines, "")
    if resume:
        config.set("checkpoint.resume", "true")
    from .core import obs, telemetry
    from .core.multiscan import run_multi
    from .fleetobs.publisher import publisher_for_job
    mesh = run_mesh(device)
    obs.configure_from_config(config, force_enable=bool(trace_path))
    # before configure_resilience: the publisher routes flight.dump.dir
    # into the spool feed when fleetobs.spool.dir is set
    publisher = publisher_for_job(config, role="multi")
    configure_resilience(config)
    telemetry.configure_from_config(config)
    exporter = telemetry.exporter_for_job(config, metrics_out)
    if publisher is not None:
        exporter = publisher.attach(exporter, config)
    flusher = telemetry.flusher_for_job(config, trace_path)
    try:
        with profiled(profile_dir):
            results = run_multi(config, in_path, out_base,
                                job_resolver(mesh.devices.flat[0]),
                                mesh=mesh,
                                log=lambda m: print(m, file=sys.stderr))
    except BaseException as exc:
        # a fatal workflow exception still leaves the black box behind
        from .core import flight
        flight.fatal(exc)
        raise
    finally:
        if flusher is not None:
            flusher.stop()
        if exporter is not None:
            exporter.stop()
        _export_trace(trace_path)
    for jid, counters in results.items():
        print(f"--- job {jid}", file=sys.stderr)
        if isinstance(counters, Counters):
            print(counters.format(), file=sys.stderr)
    return 0


def dag_main(argv) -> int:
    """``python -m avenir_tpu_torch dag -Dconf.path=<workflow.properties>
    <in> [<out base>]``: the ``workflow.*`` stage DAG (core.dag) on
    ``cuda:0`` unless ``--device cpu``: stages in topological order,
    cost-decided shared scans for same-input groups, in-memory artifact
    handoff, and stage checkpoint/resume (``--resume``)."""
    argv, device = extract_device_flag(argv)
    argv, trace_path = extract_trace_flag(argv)
    argv, metrics_out = extract_metrics_out_flag(argv)
    argv, resume = extract_resume_flag(argv)
    argv, profile_dir = extract_profile_dir_flag(argv)
    defines, positional = parse_cli_args(argv)
    if not positional:
        print("expected <input path> [<output base dir>]", file=sys.stderr)
        return 2
    in_path = positional[0]
    out_base = positional[1] if len(positional) > 1 else None

    config = load_job_config(defines, "")
    if resume:
        config.set("checkpoint.resume", "true")
    from .core import obs, telemetry
    from .core.dag import run_workflow
    from .fleetobs.publisher import publisher_for_job
    mesh = run_mesh(device)
    obs.configure_from_config(config, force_enable=bool(trace_path))
    # before configure_resilience: the publisher routes flight.dump.dir
    # into the spool feed when fleetobs.spool.dir is set
    publisher = publisher_for_job(config, role="dag")
    configure_resilience(config)
    telemetry.configure_from_config(config)
    exporter = telemetry.exporter_for_job(config, metrics_out)
    if publisher is not None:
        exporter = publisher.attach(exporter, config)
    flusher = telemetry.flusher_for_job(config, trace_path)
    try:
        with profiled(profile_dir):
            results = run_workflow(config, in_path, out_base,
                                   job_resolver(mesh.devices.flat[0]),
                                   mesh=mesh,
                                   log=lambda m: print(m, file=sys.stderr))
    except BaseException as exc:
        # a fatal workflow exception still leaves the black box behind
        from .core import flight
        flight.fatal(exc)
        raise
    finally:
        if flusher is not None:
            flusher.stop()
        if exporter is not None:
            exporter.stop()
        _export_trace(trace_path)
    for sid, counters in results.items():
        print(f"--- stage {sid}", file=sys.stderr)
        if isinstance(counters, Counters):
            print(counters.format(), file=sys.stderr)
    return 0


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m avenir_tpu_torch <JobClass> "
              "-Dconf.path=<props> <in> <out> [--device cpu|cuda] "
              "[--resume] [--trace <out.json>] [--profile-dir=<dir>]\n"
              "       python -m avenir_tpu_torch multi "
              "-Dconf.path=<manifest> <in> [<out base>] [--device cpu|cuda] "
              "[--resume] [--trace <out.json>] [--metrics-out "
              "<series.jsonl>] [--profile-dir=<dir>]\n"
              "       python -m avenir_tpu_torch dag "
              "-Dconf.path=<workflow.properties> <in> [<out base>] "
              "[--device cpu|cuda] [--resume] [--trace <out.json>] "
              "[--metrics-out <series.jsonl>] [--profile-dir=<dir>]\n"
              "       python -m avenir_tpu_torch serve "
              "-Dconf.path=<serve.properties> [--device cpu|cuda] "
              "[--trace <out.json>] [--metrics-out <series.jsonl>]\n"
              "       python -m avenir_tpu_torch stream "
              "-Dconf.path=<stream.properties> [--device cpu|cuda] "
              "[--resume] [--trace <out.json>] [--metrics-out "
              "<series.jsonl>]\n"
              "       python -m avenir_tpu_torch workload --scenario "
              "<scenario.properties> [--assert] [--device cpu|cuda] "
              "[-Dkey=value ...]\n"
              "       python -m avenir_tpu_torch fleetobs "
              "-Dfleetobs.spool.dir=<dir> [-Dfleetobs.port=N] [--once]\n"
              "       python -m avenir_tpu_torch fleetobs stitch --spool "
              "<dir> [--trace-id X] [--out f.json]\n"
              "       python -m avenir_tpu_torch router "
              "-Drouter.backends=host:p1,host:p2 [-Drouter.port=N]\n"
              "       python -m avenir_tpu_torch analyze [--strict] "
              "[--json report.json] [--rules a,b] [--list]\n"
              "                                          [--dynamic] "
              "[--seeds N] [--device cpu|cuda] [--baseline findings.json] "
              "[--update-baseline] [--no-cache]\n"
              "AVENIR_MESH=<data>x<model> runs a job, multi, dag and serve "
              "on a device mesh: data x model grid over every visible card "
              "(data*model == card count); with --device cpu, the CPU named "
              "data*model times (every position computes on the one CPU).  "
              "Unset: the one device of --device.\n"
              "known jobs:\n  " + "\n  ".join(sorted(JOBS)), file=sys.stderr)
        return 2
    job_name, rest = argv[0], argv[1:]
    if job_name == "analyze":
        # the static analysis of the package's own source (analysis.cli):
        # the rule catalog, text or JSON findings, the --strict gate, and
        # the --dynamic fold certificate on --device
        from .analysis.cli import analyze_main
        return analyze_main(rest)
    if job_name == "serve":
        # the online prediction server (serve.server)
        from .serve.server import serve_main
        return serve_main(rest)
    if job_name == "stream":
        # the streaming decision service (stream.service)
        from .stream.service import stream_main
        return stream_main(rest)
    if job_name == "workload":
        # the seeded open-loop workload harness (workload.runner)
        from .workload.runner import workload_main
        return workload_main(rest)
    if job_name in ("fleetobs", "router"):
        # byte movers: neither imports torch nor touches a device
        if any(a == "--device" or a.startswith("--device=") for a in rest):
            print(f"{job_name}: takes no --device (it moves bytes and "
                  f"reads feeds; it never touches a device)",
                  file=sys.stderr)
            return 2
        if job_name == "fleetobs":
            # the fleet observability aggregator (fleetobs.aggregator)
            from .fleetobs.aggregator import fleetobs_main
            return fleetobs_main(rest)
        # the fleet router (serve.fleet.router)
        from .serve.fleet.router import router_main
        return router_main(rest)
    if job_name == "multi":
        # the shared scan (core.multiscan)
        return multi_main(rest)
    if job_name == "dag":
        # the workflow DAG (core.dag)
        return dag_main(rest)
    prefix = resolve(job_name)[2]
    rest, device = extract_device_flag(rest)
    rest, trace_path = extract_trace_flag(rest)
    rest, resume = extract_resume_flag(rest)
    rest, profile_dir = extract_profile_dir_flag(rest)
    defines, positional = parse_cli_args(rest)
    if len(positional) < 2:
        print("expected <input path> <output path>", file=sys.stderr)
        return 2
    config = load_job_config(defines, prefix)
    if resume:
        config.set("checkpoint.resume", "true")
    from .core import obs
    obs.configure_from_config(config, force_enable=bool(trace_path))
    configure_resilience(config)
    mesh = cli_mesh(device)
    job = job_class(job_name)(config, device=(
        device if mesh is None else mesh.devices.flat[0]))
    # the streaming topology's run is a long-lived event loop that takes
    # no mesh, as the reference's
    on_mesh = ({"mesh": mesh} if mesh is not None and "mesh" in
               inspect.signature(job.run).parameters else {})
    try:
        with profiled(profile_dir):
            result = job.run(positional[0], positional[1], **on_mesh)
    finally:
        _export_trace(trace_path)
    if isinstance(result, Counters):
        print(result.format(), file=sys.stderr)
        return 0
    # an iterative job's status (LogisticRegressionJob: 100 converged,
    # 101 not yet) is the exit code, as the reference driver's
    return int(result or 0)


if __name__ == "__main__":
    raise SystemExit(main())
