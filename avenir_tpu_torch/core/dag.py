"""Cost-based workflow DAG engine: stage scheduling over shared scans,
in-memory artifact handoff, and stage-granularity checkpoint/resume.

The port's counterpart of ``avenir_tpu/core/dag.py``.  avenir's runbooks
chain bin -> train -> feature-select -> retrain -> validate by hand,
round-tripping every intermediate through text files.  This module runs
such a chain as one declared DAG:

- **Manifest** (``workflow.*`` keys, :func:`load_workflow`): a DAG of
  stages, each a job of the CLI registry or one of the built-in
  stage classes below, with a declared input (the workflow input
  ``$input``, another stage's id, or ``path:<p>``) and ``@<stage>``
  artifact references inside stage config values.  Unknown stages,
  cycles, undeclared references and duplicate output paths fail fast
  naming the key (:class:`WorkflowConfigError`).

- **Cost-based fusion** (:func:`fusion_decision`): ready stages that
  share one input and export a ``core.multiscan.FoldSpec`` run as one
  shared scan (``core.multiscan.run_multi``) when the model says fusion
  wins::

      separate = sum_i max(scan_sec, fold_i)
      fused    = max(scan_sec, sum_i fold_i) + n * fuse_overhead

  Fold estimates come from the ``multiscan.fold`` spans recorded earlier
  in this process, else ``workflow.stage.<id>.cost.fold.sec``, else
  ``workflow.cost.fold.sec.default``; ``workflow.fuse=always|never``
  overrides.

- **In-memory artifact handoff** (``core.io.ArtifactStore``): outputs
  that a later stage reads through ``read_lines`` (``@`` references,
  built-in stage inputs) are kept in memory; the first memory read of
  each is checked against the file (``workflow.handoff.verify``), and
  ``sink.file=false`` skips the file.

- **Stage checkpointing** (``core.checkpoint.WorkflowCheckpointer``):
  every completed stage is recorded with its params hash and input and
  output fingerprints; ``--resume`` skips stages whose record validates
  and restarts the failed one, mid-scan when its own
  ``checkpoint.interval.chunks`` sidecar survived.

Stages run on the device of the resolver that builds them (the CLI's
``job_resolver(device)``) and under the workflow's ``mesh``
(``multiscan.run_standalone``'s rule for solo stages): a solo stage whose
job has no multi-device form raises ``NotImplementedError`` on a mesh of
several positions; it never falls back to one device.

Built-in stage classes (only inside a workflow manifest):

- :class:`FeatureSelect`: an MI ranking artifact -> the base schema with
  the ``select.top.features`` best features kept.
- :class:`RegistryPublish`: loads the input model into a
  ``serve.registry.ModelRegistry`` entry and writes the exact bytes the
  registry serves.

CLI: ``python -m avenir_tpu_torch dag -Dconf.path=<workflow.properties>
<in> [<out base>] [--resume] [--device cpu]`` (``resource/workflow/``).
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .config import JobConfig, parse_properties
from .io import (KEY_REQUIRE_SUCCESS, ArtifactStore, _input_files,
                 read_lines, set_artifact_store, set_require_success,
                 write_output)
from .metrics import Counters
from .obs import get_tracer, new_trace_context, traced_run
from . import telemetry

KEY_STAGES = "workflow.stages"
KEY_FUSE = "workflow.fuse"
KEY_COST_SCAN_MBPS = "workflow.cost.scan.mb.per.sec"
KEY_COST_SCAN_CACHED_MBPS = "workflow.cost.scan.cached.mb.per.sec"
KEY_COST_FOLD_DEFAULT = "workflow.cost.fold.sec.default"
KEY_COST_FUSE_OVERHEAD = "workflow.cost.fuse.overhead.sec"
KEY_CKPT_PATH = "workflow.checkpoint.path"
KEY_HANDOFF_VERIFY = "workflow.handoff.verify"

DEFAULT_SCAN_MBPS = 200.0
DEFAULT_CACHED_SCAN_MBPS = 2000.0
DEFAULT_FOLD_SEC = 0.02
DEFAULT_FUSE_OVERHEAD_SEC = 0.005

#: per-stage keys the manifest consumes itself (every other key under
#: ``workflow.stage.<id>.`` overlays the stage's job config)
STAGE_RESERVED = ("class", "conf.path", "output.path", "input",
                  "sink.file", "cost.fold.sec")

INPUT_SENTINEL = "$input"
PATH_PREFIX = "path:"


class WorkflowConfigError(ValueError):
    """A ``workflow.*`` manifest error; names the offending key or
    stage."""


class Stage:
    """One declared stage: id, job class, resolved config, input
    reference, output path, and its dependency edges (its input and its
    ``@<stage>`` references, the latter also in ``ref_deps``)."""

    __slots__ = ("sid", "cls_name", "props", "input_ref", "out_path",
                 "sink_file", "cost_fold_sec", "deps", "ref_deps")

    def __init__(self, sid: str, cls_name: str, props: Dict[str, str],
                 input_ref: str, out_path: str, sink_file: bool,
                 cost_fold_sec: Optional[float], deps: List[str],
                 ref_deps: Optional[List[str]] = None):
        self.sid = sid
        self.cls_name = cls_name
        self.props = props
        self.input_ref = input_ref
        self.out_path = out_path
        self.sink_file = sink_file
        self.cost_fold_sec = cost_fold_sec
        self.deps = deps
        self.ref_deps = ref_deps if ref_deps is not None else []

    #: config families that never change a stage's output bytes, left out
    #: of the checkpoint identity (so ``--resume`` or a fault plan does
    #: not invalidate every completed stage)
    _VOLATILE_PREFIXES = ("checkpoint.", "fault.", "retry.", "obs.",
                          "telemetry.")

    def params_obj(self) -> dict:
        """The identity the stage checkpoint hashes."""
        props = {k: v for k, v in self.props.items()
                 if not k.startswith(self._VOLATILE_PREFIXES)}
        return {"class": self.cls_name, "props": props,
                "input": self.input_ref, "out": self.out_path}


# ---------------------------------------------------------------------------
# built-in stage classes
# ---------------------------------------------------------------------------

class FeatureSelect:
    """Feature selection: a ``MutualInformation`` output -> the schema
    ``select.schema.file.path`` with every feature outside the
    ``select.top.features`` best ranked (``select.algorithm``'s section,
    default the first) demoted to ``feature: false`` and the class
    attribute pinned (``classAttr: true``), written as one JSON file."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        from ..models.mutual_info import MutualInformation
        from .schema import FeatureSchema

        cfg = self.config
        counters = Counters()
        k = cfg.must_int("select.top.features")
        if k < 1:
            raise WorkflowConfigError(
                f"select.top.features must be >= 1: {k}")
        schema_path = cfg.must("select.schema.file.path")
        scores = MutualInformation.parse_scores(
            read_lines(in_path), algorithm=cfg.get("select.algorithm"),
            delim=cfg.field_delim_out())
        ranked = sorted(scores, key=lambda s: (-s[1], s[0]))
        doc = json.loads("\n".join(read_lines(schema_path)))
        fields = doc.get("fields", [])
        feature_ords = {f["ordinal"] for f in fields if f.get("feature")}
        unknown = [o for o, _ in ranked if o not in feature_ords]
        if unknown:
            raise WorkflowConfigError(
                f"FeatureSelect: MI ranking names ordinals {unknown} that "
                f"are not feature fields of {schema_path}")
        if k > len(ranked):
            raise WorkflowConfigError(
                f"select.top.features={k} but the MI artifact ranks only "
                f"{len(ranked)} features")
        keep = {o for o, _ in ranked[:k]}
        # the implicit class-attribute rule is "neither feature nor id",
        # so demoting features would add candidates: pin the class first
        class_ord = FeatureSchema.from_json(
            json.dumps(doc)).class_attr_field().ordinal
        for f in fields:
            if f["ordinal"] == class_ord:
                f["classAttr"] = True
            elif f.get("feature") and f["ordinal"] not in keep:
                f["feature"] = False
                counters.incr("Select", "Features dropped")
            elif f.get("feature"):
                counters.incr("Select", "Features kept")
        write_output(out_path, json.dumps(doc, indent=1).split("\n"),
                     as_dir=False)
        return counters


class RegistryPublish:
    """Terminal publish stage: the input model -> a serving registry
    entry built from the stage config (``publish.model.name``,
    ``publish.kind``, ``publish.version``, ``publish.warmup``; every other
    key passes through as the model's scoring config, with
    ``bayesian.model.file.path`` defaulting to the stage input).  The
    adapter is fully built before the entry is visible; the stage output
    is the exact model bytes the registry serves."""

    _RESERVED_PREFIXES = ("publish.", "pipeline.", "checkpoint.",
                          "workflow.", "fault.", "retry.", "obs.",
                          "telemetry.")

    def __init__(self, config: JobConfig, device=None):
        from ..device import resolve_device
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        from ..device import one_device_mesh
        from ..serve.registry import ModelRegistry

        device = one_device_mesh(mesh, self.device, "RegistryPublish")
        cfg = self.config
        counters = Counters()
        name = cfg.must("publish.model.name")
        props = {"serve.models": name,
                 f"serve.model.{name}.kind": cfg.get("publish.kind",
                                                     "naiveBayes"),
                 f"serve.model.{name}.version": cfg.get("publish.version",
                                                        "1")}
        for k, v in cfg.props.items():
            if not k.startswith(self._RESERVED_PREFIXES):
                props.setdefault(f"serve.model.{name}.{k}", v)
        props.setdefault(f"serve.model.{name}.bayesian.model.file.path",
                         in_path)
        registry = ModelRegistry(JobConfig(props), device=device)
        entry = registry.load(name,
                              warmup=cfg.get_boolean("publish.warmup",
                                                     False))
        # the published artifact: the exact lines the adapter was built
        # from
        write_output(out_path, list(read_lines(in_path)))
        counters.incr("Registry", "Published versions")
        counters.set("Registry", "Warmup buckets",
                     entry.counters.get("Serve", "Warmup buckets"))
        return counters


#: built-in workflow-only stage classes (looked up before the registry)
BUILTIN_STAGES: Dict[str, type] = {
    "FeatureSelect": FeatureSelect,
    "RegistryPublish": RegistryPublish,
}


# ---------------------------------------------------------------------------
# manifest loading + validation
# ---------------------------------------------------------------------------

def _stage_ids(config: JobConfig) -> List[str]:
    ids = [s.strip() for s in config.must(KEY_STAGES).split(",")
           if s.strip()]
    if not ids:
        raise WorkflowConfigError(f"{KEY_STAGES} is empty")
    if len(set(ids)) != len(ids):
        raise WorkflowConfigError(
            f"duplicate stage ids in {KEY_STAGES}: {ids}")
    for sid in ids:
        if not sid.replace("_", "").replace("-", "").isalnum():
            raise WorkflowConfigError(
                f"bad stage id {sid!r} in {KEY_STAGES} (use letters, "
                f"digits, '-', '_')")
    return ids


def _check_orphan_stage_keys(config: JobConfig, ids: Sequence[str]) -> None:
    """Every ``workflow.stage.<id>.*`` key must name a declared stage."""
    known = set(ids)
    for key in config.props:
        if not key.startswith("workflow.stage."):
            continue
        sid = key[len("workflow.stage."):].split(".", 1)[0]
        if sid not in known:
            raise WorkflowConfigError(
                f"{key}: stage {sid!r} is not declared in {KEY_STAGES} "
                f"({', '.join(ids)})")


def load_workflow(config: JobConfig, in_path: str,
                  out_base: Optional[str]) -> List[Stage]:
    """Parse and validate the ``workflow.*`` manifest into Stages
    (declaration order, dependency edges resolved, ``@`` references
    replaced by output paths)."""
    ids = _stage_ids(config)
    _check_orphan_stage_keys(config, ids)
    known = set(ids)
    base_props = {k: v for k, v in config.props.items()
                  if not k.startswith("workflow.")}

    stages: List[Stage] = []
    out_seen: Dict[str, str] = {}
    for sid in ids:
        skey = f"workflow.stage.{sid}"
        try:
            cls_name = config.must(f"{skey}.class")
        except KeyError as exc:
            raise WorkflowConfigError(str(exc)) from None
        props = dict(base_props)
        conf_path = config.get(f"{skey}.conf.path")
        if conf_path:
            with open(conf_path, "r") as fh:
                props.update(parse_properties(fh.read()))
        sub = config.subkeys(skey)
        for k, v in sub.items():
            if k not in STAGE_RESERVED:
                props[k] = v

        input_ref = sub.get("input", INPUT_SENTINEL)
        deps: List[str] = []
        ref_deps: List[str] = []
        if input_ref == INPUT_SENTINEL or input_ref.startswith(PATH_PREFIX):
            pass
        elif input_ref in known:
            deps.append(input_ref)
        else:
            raise WorkflowConfigError(
                f"{skey}.input={input_ref!r}: not {INPUT_SENTINEL!r}, not "
                f"'{PATH_PREFIX}<path>', and not a declared stage id "
                f"({', '.join(ids)})")

        for k, v in sorted(props.items()):
            if not v.startswith("@"):
                continue
            ref = v[1:]
            if ref not in known:
                raise WorkflowConfigError(
                    f"{skey}.{k}={v!r}: artifact reference to undeclared "
                    f"stage {ref!r} (declared: {', '.join(ids)})")
            if ref == sid:
                raise WorkflowConfigError(
                    f"{skey}.{k}={v!r}: a stage cannot reference its own "
                    f"output")
            if ref not in deps:
                deps.append(ref)
            if ref not in ref_deps:
                ref_deps.append(ref)

        out_path = sub.get("output.path")
        if out_path is None:
            if out_base is None:
                raise WorkflowConfigError(
                    f"stage {sid!r}: no {skey}.output.path and no <out> "
                    f"CLI argument to derive it from")
            out_path = os.path.join(out_base, sid)
        ap = os.path.abspath(out_path)
        if ap in out_seen:
            raise WorkflowConfigError(
                f"{skey}.output.path={out_path!r} duplicates stage "
                f"{out_seen[ap]!r}'s output path")
        out_seen[ap] = sid

        sink_file = str(sub.get("sink.file", "true")).lower() != "false"
        cost_fold = sub.get("cost.fold.sec")
        stages.append(Stage(sid, cls_name, props, input_ref, out_path,
                            sink_file,
                            float(cost_fold) if cost_fold else None, deps,
                            ref_deps))

    _check_acyclic(stages)
    # sink.file=false only for artifacts read through the overlay: a
    # regular job's input= is byte-scanned from disk
    overlay = overlay_consumed(stages)
    for s in stages:
        if not s.sink_file and s.sid not in overlay:
            raise WorkflowConfigError(
                f"workflow.stage.{s.sid}.sink.file=false: stage "
                f"{s.sid!r}'s output is not consumed through the "
                f"in-memory overlay (only @{s.sid} config references and "
                f"built-in-stage inputs are), so its consumers need the "
                f"file on disk")
    by_id = {s.sid: s for s in stages}
    for s in stages:
        for k, v in list(s.props.items()):
            if v.startswith("@"):
                s.props[k] = by_id[v[1:]].out_path
    return stages


def overlay_consumed(stages: Sequence[Stage]) -> set:
    """Stage ids whose output a downstream stage reads through the
    in-memory overlay: ``@<stage>`` references and built-in stage inputs.
    Regular jobs byte-scan their ``input=`` from disk, so keeping those
    outputs in memory would only pin dataset-sized intermediates."""
    known = {s.sid for s in stages}
    out = {d for s in stages for d in s.ref_deps}
    out |= {s.input_ref for s in stages
            if s.cls_name in BUILTIN_STAGES and s.input_ref in known}
    return out


def _check_acyclic(stages: Sequence[Stage]) -> None:
    """Kahn's algorithm; the stages left over form the reported cycle."""
    indeg = {s.sid: len(s.deps) for s in stages}
    children: Dict[str, List[str]] = {s.sid: [] for s in stages}
    for s in stages:
        for d in s.deps:
            children[d].append(s.sid)
    ready = [sid for sid, n in indeg.items() if n == 0]
    done = 0
    while ready:
        sid = ready.pop()
        done += 1
        for c in children[sid]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if done != len(stages):
        cyc = sorted(sid for sid, n in indeg.items() if n > 0)
        raise WorkflowConfigError(
            f"dependency cycle among workflow stages: {', '.join(cyc)} "
            f"(check their workflow.stage.<id>.input/@ references)")


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def _scan_bytes(path: str, store: Optional[ArtifactStore]) -> int:
    """Bytes one scan of ``path`` reads: its parts on disk, or the
    in-memory artifact's line bytes for an upstream output with no
    file."""
    if store is not None:
        lines = store.peek(path)
        if lines is not None and not os.path.exists(path):
            return sum(len(l) + 1 for l in lines)
    try:
        return sum(os.path.getsize(fp) for fp in _input_files(path))
    except OSError:
        return 0


def measured_fold_sec(sid: str, cls_name: str, scan_bytes: int,
                      chunk_rows: int, row_bytes: int) -> Optional[float]:
    """A stage's fold time from the ``multiscan.fold`` spans recorded
    earlier in this process for its id or class (the spans' ``job``
    attribute): the mean span time scaled to this scan's estimated chunk
    count.  None when no such span exists."""
    spans = [s for s in get_tracer().spans("multiscan.fold")
             if s.attrs.get("job") in (sid, cls_name)]
    if not spans:
        return None
    mean_chunk_sec = (sum(s.dur_ns for s in spans) / len(spans)) / 1e9
    est_rows = scan_bytes / max(row_bytes, 1)
    est_chunks = max(est_rows / max(chunk_rows, 1), 1.0)
    return mean_chunk_sec * est_chunks


def fusion_decision(stages: Sequence[Stage], scan_bytes: int,
                    config: JobConfig, row_bytes: int = 64,
                    in_path: Optional[str] = None) -> Tuple[bool, dict]:
    """Fuse these same-input ready stages into one shared scan, or run
    them separately?  Returns ``(fuse, detail)`` with every estimate.
    With ``in_path`` given and a published ingest-cache artifact for it,
    scans are priced at ``workflow.cost.scan.cached.mb.per.sec``."""
    mode = (config.get(KEY_FUSE, "auto") or "auto").lower()
    if mode not in ("auto", "always", "never"):
        raise WorkflowConfigError(
            f"{KEY_FUSE}={mode!r}: use auto, always, or never")
    scan_cached = False
    if in_path is not None:
        from .ingestcache import probe_scan_boost
        scan_cached = probe_scan_boost(config, in_path)
    if scan_cached:
        mbps = config.get_float(KEY_COST_SCAN_CACHED_MBPS,
                                DEFAULT_CACHED_SCAN_MBPS)
    else:
        mbps = config.get_float(KEY_COST_SCAN_MBPS, DEFAULT_SCAN_MBPS)
    fold_default = config.get_float(KEY_COST_FOLD_DEFAULT, DEFAULT_FOLD_SEC)
    overhead = config.get_float(KEY_COST_FUSE_OVERHEAD,
                                DEFAULT_FUSE_OVERHEAD_SEC)
    scan_sec = scan_bytes / (mbps * 1e6) if mbps > 0 else 0.0
    chunk_rows = config.pipeline_chunk_rows(default=1 << 16) or (1 << 16)

    folds: Dict[str, float] = {}
    sources: Dict[str, str] = {}
    for s in stages:
        measured = measured_fold_sec(s.sid, s.cls_name, scan_bytes,
                                     chunk_rows, row_bytes)
        if s.cost_fold_sec is not None:
            folds[s.sid], sources[s.sid] = s.cost_fold_sec, "configured"
        elif measured is not None:
            folds[s.sid], sources[s.sid] = measured, "measured"
        else:
            folds[s.sid], sources[s.sid] = fold_default, "default"

    separate_sec = sum(max(scan_sec, f) for f in folds.values())
    fused_sec = (max(scan_sec, sum(folds.values()))
                 + overhead * len(folds))
    if mode == "always":
        fuse = True
    elif mode == "never":
        fuse = False
    else:
        fuse = fused_sec < separate_sec
    return fuse, {"mode": mode, "scan_bytes": scan_bytes,
                  "scan_sec": scan_sec, "scan_cached": scan_cached,
                  "fold_sec": folds,
                  "fold_source": sources, "separate_sec": separate_sec,
                  "fused_sec": fused_sec, "fuse": fuse}


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _builtin_or_resolve(cls_name: str, resolver: Callable):
    """(factory, prefix) for a stage class: the built-ins first, built on
    the resolver's device, then the CLI job registry.  Every factory
    carries ``job_class``, so fusability is probed without building."""
    if cls_name in BUILTIN_STAGES:
        cls = BUILTIN_STAGES[cls_name]
        device = getattr(resolver, "device", None)

        def factory(config):
            return cls(config, device=device)
        factory.job_class = cls
        return factory, ""
    return resolver(cls_name)


def _group_ckpt_path(out_base: Optional[str], in_path: str,
                     sids: Sequence[str]) -> str:
    """The fused group's mid-scan sidecar.  Membership is part of the
    name, so a resume that groups differently never loads a stale
    sidecar of the old grouping."""
    tag = "_dag_scan_" + "+".join(sorted(sids)) + ".ckpt"
    return (os.path.join(out_base, tag) if out_base
            else in_path + "." + tag)


def run_workflow(config: JobConfig, in_path: str, out_base: Optional[str],
                 resolver: Callable, mesh=None,
                 log: Optional[Callable] = None) -> Dict[str, Counters]:
    """Execute a ``workflow.*`` manifest: stages in topological order,
    cost-decided shared scans for same-input ready groups, in-memory
    artifact handoff, and stage checkpoint/resume.  ``resolver`` builds
    the registry's jobs (``cli.job_resolver(device)``); ``mesh`` goes to
    every stage.  Returns ``{stage id: Counters}``."""
    from .checkpoint import KEY_RESUME, WorkflowCheckpointer
    from .multiscan import run_standalone

    def say(msg: str) -> None:
        if log is not None:
            log(msg)

    tracer = get_tracer()
    metrics = telemetry.get_metrics()
    stages = load_workflow(config, in_path, out_base)
    by_id = {s.sid: s for s in stages}
    resume = config.get_boolean(KEY_RESUME, False)
    ck_path = config.get(KEY_CKPT_PATH,
                         os.path.join(out_base, "_workflow.ckpt")
                         if out_base else in_path + ".workflow.ckpt")
    ck = WorkflowCheckpointer.from_config(config, ck_path, in_path,
                                          resume=resume)
    if ck.degraded_reason:
        say(f"dag: {ck.degraded_reason}")

    store = ArtifactStore(
        verify=config.get_boolean(KEY_HANDOFF_VERIFY, True))
    overlay = overlay_consumed(stages)
    for s in stages:
        if s.sid in overlay:
            store.register(s.out_path, sink_file=s.sink_file)

    def stage_in(s: Stage) -> str:
        if s.input_ref == INPUT_SENTINEL:
            return in_path
        if s.input_ref.startswith(PATH_PREFIX):
            return s.input_ref[len(PATH_PREFIX):]
        return by_id[s.input_ref].out_path

    def stage_inputs(s: Stage) -> Dict[str, str]:
        """Every artifact the stage consumes: its input and each
        dependency's output (a rewritten dependency invalidates the
        stage's record)."""
        ins = {"$input": stage_in(s)}
        for d in s.deps:
            ins[d] = by_id[d].out_path
        return ins

    def record_done(s: Stage, t0: float) -> None:
        ck.record(s.sid, WorkflowCheckpointer.params_key(s.params_obj()),
                  stage_inputs(s), {"out": s.out_path})
        metrics.counters.incr("Dag", "Stages completed")
        metrics.histogram("dag.stage.sec").record(
            max(time.monotonic() - t0, 0.0))

    results: Dict[str, Counters] = {}
    done: set = set()
    # io.require.success applies to every stage input below; it is
    # process-global, so the finally restores the caller's setting
    prev_strict = set_require_success(
        config.get_boolean(KEY_REQUIRE_SUCCESS, False))
    prev_store = set_artifact_store(store)
    # one trace for the whole workflow: every stage span joins it
    wf_ctx = new_trace_context(sampled=True) if tracer.enabled else None
    try:
        with tracer.span("dag.run", stages=",".join(by_id), ctx=wf_ctx,
                         span_id=wf_ctx.span_id if wf_ctx else None):
            while len(done) < len(stages):
                ready = [s for s in stages if s.sid not in done
                         and all(d in done for d in s.deps)]
                assert ready, "scheduler stalled (cycle missed?)"

                # resume: skip completed stages whose record validates (a
                # memory-only output died with the killed run, so its
                # stage always re-runs)
                ran_any = False
                for s in list(ready):
                    if not (resume and s.sink_file):
                        continue
                    if ck.stage_done(
                            s.sid,
                            WorkflowCheckpointer.params_key(s.params_obj()),
                            stage_inputs(s), {"out": s.out_path}):
                        say(f"dag: skipping completed stage {s.sid!r} "
                            f"(checkpoint validated)")
                        metrics.counters.incr("Dag", "Stages skipped")
                        results[s.sid] = Counters()
                        done.add(s.sid)
                        ready.remove(s)
                        ran_any = True
                if not ready:
                    continue

                # group fusable same-input stages, probing the class so
                # that no job is built twice (run_multi builds its
                # own; a spec that turns out None there runs standalone)
                groups: Dict[str, List[Stage]] = {}
                solos: List[Stage] = []
                factories: Dict[str, tuple] = {}
                for s in ready:
                    factory, prefix = _builtin_or_resolve(s.cls_name,
                                                          resolver)
                    factories[s.sid] = (factory, prefix)
                    cls = getattr(factory, "job_class", factory)
                    if callable(getattr(cls, "fold_spec", None)):
                        groups.setdefault(
                            os.path.abspath(stage_in(s)), []).append(s)
                    else:
                        solos.append(s)

                units: List[Tuple[str, List[Stage]]] = []
                for members in groups.values():
                    if len(members) < 2:
                        solos.extend(members)
                        continue
                    fuse, detail = fusion_decision(
                        members, _scan_bytes(stage_in(members[0]), store),
                        config, in_path=stage_in(members[0]))
                    sids = ",".join(m.sid for m in members)
                    say(f"dag: cost model ({detail['mode']}): stages "
                        f"[{sids}] scan={detail['scan_sec']:.4f}s "
                        f"separate={detail['separate_sec']:.4f}s "
                        f"fused={detail['fused_sec']:.4f}s -> "
                        f"{'FUSE into one shared scan' if fuse else 'run separately'}")
                    if fuse:
                        units.append(("fused", members))
                    else:
                        solos.extend(members)
                for s in solos:
                    units.append(("solo", [s]))

                for mode, members in units:
                    t0 = time.monotonic()
                    if mode == "fused":
                        _run_fused(members, config, stage_in(members[0]),
                                   out_base, in_path, resolver, mesh, say,
                                   results, resume)
                        metrics.counters.incr("Dag", "Shared scans")
                        for m in members:
                            record_done(m, t0)
                            done.add(m.sid)
                    else:
                        s = members[0]
                        factory, prefix = factories[s.sid]
                        job = factory(JobConfig(s.props, prefix))
                        say(f"dag: running stage {s.sid!r} "
                            f"({s.cls_name}) standalone")
                        with tracer.span("dag.stage.run", stage=s.sid,
                                         cls=s.cls_name, mode="solo"):
                            results[s.sid] = run_standalone(
                                job, stage_in(s), s.out_path, mesh)
                        record_done(s, t0)
                        done.add(s.sid)
                    ran_any = True
                assert ran_any
        ck.complete()
        # fused-group sidecars are named by membership, so a resume that
        # grouped differently never loads the old one: sweep them all
        for p in glob.glob(_group_ckpt_path(out_base, in_path, ["*"])):
            try:
                os.unlink(p)
            except OSError:
                pass
    finally:
        set_artifact_store(prev_store)
        set_require_success(prev_strict)
    metrics.counters.set("Dag", "Memory handoffs", store.memory_reads)
    say(f"dag: workflow complete — {len(stages)} stages, "
        f"{store.memory_reads} in-memory artifact reads")
    return results


def _run_fused(members: List[Stage], config: JobConfig, scan_in: str,
               out_base: Optional[str], wf_in: str, resolver: Callable,
               mesh, say, results: Dict[str, Counters],
               resume: bool) -> None:
    """One shared scan over ``scan_in`` feeding every member, through
    ``core.multiscan.run_multi`` on a synthetic ``multi.*`` manifest (its
    mid-scan checkpoint, withdrawal and standalone re-run come with
    it).  With no mesh the scan runs on the resolver's device."""
    from .multiscan import run_multi

    if mesh is None and getattr(resolver, "device", None) is not None:
        from ..device import resolve_device
        from ..parallel.mesh import make_mesh
        mesh = make_mesh([resolve_device(resolver.device)])
    sids = [m.sid for m in members]
    props: Dict[str, str] = {"multi.jobs": ",".join(sids)}
    for k, v in config.props.items():
        if k.startswith(("pipeline.", "checkpoint.", "fault.", "retry.",
                         "ingest.")) or k in ("field.delim.regex",
                                              "field.delim.out",
                                              "field.delim"):
            props[k] = v
    props["checkpoint.path"] = _group_ckpt_path(out_base, wf_in, sids)
    if resume:
        props["checkpoint.resume"] = "true"
    for m in members:
        props[f"multi.job.{m.sid}.class"] = m.cls_name
        props[f"multi.job.{m.sid}.output.path"] = m.out_path
        for k, v in m.props.items():
            props[f"multi.job.{m.sid}.{k}"] = v
    with get_tracer().span("dag.stage.run", stage=",".join(sids),
                           mode="fused"):
        results.update(run_multi(JobConfig(props), scan_in, None, resolver,
                                 mesh=mesh, log=say))
