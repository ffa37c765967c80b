"""Runtime fold-algebra verification: split invariance as a property.

The port's counterpart of ``avenir_tpu/core/algebra.py``, the fold
certificate.  A multi-host run rests on every registered fold being a
commutative monoid: partial folds combine by a sum
(``core.multiscan.merge_carries``), input splits become byte-range scans,
and telemetry aggregates by ``merge_snapshots``.  This module tests the
algebra as properties, on the port's device mesh (``parallel/mesh.py``):

- **split invariance**: ``fold(A ++ B)`` equals the fold over chunks cut
  at random split points; the finalize output must be byte-identical
  however the stream is chunked (the Hadoop input-split contract).
- **carry merge**: ``finalize(merge_carries(fold(A), fold(B))) ==
  finalize(fold(A ++ B))``, the sum claim, on real device carries.  Host
  encode state stays sequential (one encoder sees both halves, as in one
  shared scan), so this certifies the device fold's monoid; per-host
  encoder alignment is a multi-host port's own obligation.
- **chunk-permutation invariance**: the chunks fed in a permuted order
  give the same output lines (compared as a set: label discovery order
  may reorder them).
- **snapshot merge**: ``merge_snapshots`` over per-part registries equals
  the single-registry run, commutatively and associatively; the same for
  ``LatencyHistogram.merge`` (exact equality through dyadic samples).

A failing arrangement shrinks: split points are removed while the failure
persists, and the report names the spec, the seed and the minimal split
points, a reproducer.  Non-commutative reducers are a known
silent-corruption class (Xiao et al., ICSE 2014).

:func:`run_dynamic` runs the whole certificate: every exporter of a
``fold_spec`` in the port's job registry against its canned workload
(:func:`verification_jobs`; an exporter without one fails the coverage
check), plus the two merges.
"""

from __future__ import annotations

import functools
import json
import os
import random
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .binning import ChunkedEncodeUnsupported
from . import multiscan, pipeline, telemetry
from .obs import LatencyHistogram, Metrics

DEFAULT_SEEDS = (11, 23, 47)
MIN_CHUNK_ROWS = 24        # split points keep chunk 0 big enough to
#                            size caps (first-chunk headroom contract)


class AlgebraCheck:
    __slots__ = ("name", "ok", "detail")

    def __init__(self, name: str, ok: bool, detail: str = ""):
        self.name = name
        self.ok = ok
        self.detail = detail


class AlgebraReport:
    """One (spec, seed) verification outcome: every property checked,
    the split points used, and — on failure — the shrunk minimal split
    set that still reproduces it."""

    def __init__(self, spec: str, seed: int, mesh_desc: str = ""):
        self.spec = spec
        self.seed = seed
        self.mesh_desc = mesh_desc
        self.splits: List[int] = []
        self.shrunk: Optional[List[int]] = None
        self.checks: List[AlgebraCheck] = []
        self.withdrawn: Optional[str] = None

    def add(self, name: str, ok: bool, detail: str = "") -> None:
        self.checks.append(AlgebraCheck(name, ok, detail))

    @property
    def failed(self) -> bool:
        return any(not c.ok for c in self.checks)

    def format(self) -> str:
        head = (f"algebra[{self.spec}] seed={self.seed} "
                f"mesh={self.mesh_desc or '?'} splits={self.splits}")
        if self.withdrawn:
            return f"{head}  WITHDRAWN ({self.withdrawn})"
        lines = [head]
        for c in self.checks:
            mark = "ok" if c.ok else "FAIL"
            line = f"  {c.name}: {mark}"
            if c.detail:
                line += f"  ({c.detail})"
            lines.append(line)
        if self.shrunk is not None:
            lines.append(f"  shrunk reproducer: spec={self.spec} "
                         f"seed={self.seed} splits={self.shrunk}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"spec": self.spec, "seed": self.seed,
                "mesh": self.mesh_desc, "splits": self.splits,
                "shrunk": self.shrunk, "withdrawn": self.withdrawn,
                "checks": [{"name": c.name, "ok": c.ok,
                            "detail": c.detail} for c in self.checks],
                "failed": self.failed}


class _BindStub:
    """Minimal engine stand-in for ``spec.bind`` outside a real
    MultiScanEngine (no co-registered jobs: every encoder is its own
    canonical instance)."""

    def __init__(self):
        self._encoders: Dict[object, object] = {}

    def shared_encoder(self, key, enc):
        return self._encoders.setdefault(key, enc)


def _segments(rows: Sequence[str], splits: Sequence[int]) -> List[bytes]:
    """Byte chunks of the CSV rows cut at the given row offsets."""
    bounds = [0] + sorted(set(splits)) + [len(rows)]
    out = []
    for a, b in zip(bounds, bounds[1:]):
        if b > a:
            out.append(("\n".join(rows[a:b]) + "\n").encode())
    return out


def run_spec_over_segments(spec_factory: Callable[[], multiscan.FoldSpec],
                           segments: Sequence[bytes],
                           mesh,
                           delim: str = ",",
                           merge_at: Optional[int] = None) -> List[str]:
    """Drive ONE fresh FoldSpec over the segment list as the shared-scan
    engine would (the host encode, the transfer onto ``mesh``, the fold),
    finalize, and return the emitted output lines.

    ``merge_at`` splits the device fold into two carries at that segment
    index and combines them with :func:`multiscan.merge_carries` before
    finalize: the multi-host sum.  Host encode state stays sequential."""
    from .io import read_lines

    spec = spec_factory()
    spec.bind(_BindStub())
    xfer = pipeline.ChunkTransfer(mesh=mesh)
    folds: List[Optional[pipeline.ChunkFold]] = [None, None]
    fed = False
    for k, seg in enumerate(segments):
        ctx = multiscan.ChunkContext(seg, delim)
        arrs = spec.encode(ctx)
        if arrs is None:
            continue
        fed = True
        if spec.local_fn is None:
            continue
        group = 0 if merge_at is None or k < merge_at else 1
        cf = folds[group]
        if cf is None:
            cf = folds[group] = pipeline.ChunkFold(
                spec.local_fn, static_args=spec.static_args, mesh=mesh)
        cf.fold(xfer(tuple(arrs)))
    carry = None
    if spec.local_fn is not None:
        parts = [f.result() for f in folds if f is not None]
        if not parts and not fed:
            raise ChunkedEncodeUnsupported("empty stream")
        if parts:
            carry = functools.reduce(multiscan.merge_carries, parts)
    spec.finalize(carry)
    return list(read_lines(spec.out_path))


def _split_points(rng: random.Random, n_rows: int, n_splits: int,
                  min_chunk: int = MIN_CHUNK_ROWS) -> List[int]:
    lo, hi = min_chunk, n_rows - min_chunk
    if hi <= lo:
        return []
    pts = sorted(rng.sample(range(lo, hi), min(n_splits, hi - lo)))
    return pts


def verify_fold_spec(spec_factory: Callable[[], multiscan.FoldSpec],
                     rows: Sequence[str],
                     mesh,
                     seeds: Sequence[int] = DEFAULT_SEEDS,
                     delim: str = ",",
                     n_splits: int = 3,
                     spec_name: Optional[str] = None
                     ) -> List[AlgebraReport]:
    """Property-test one FoldSpec's split invariance: for each seed,
    fold the whole stream as one chunk, at randomized split points, at
    a permuted chunk order, and through a two-carry merge — all four
    must emit the same output (byte-identical for splits/merge,
    line-set-identical for permutation).  Returns one
    :class:`AlgebraReport` per seed; a failing split arrangement is
    shrunk to a minimal reproducer."""
    mesh_desc = f"{mesh.size}dev"
    # one throwaway probe for seed-invariant facts (name, host-only?)
    probe = spec_factory()
    name = spec_name or getattr(probe, "name", "spec")
    host_only = probe.local_fn is None
    reports = []

    def run(splits, merge_at=None, order=None):
        segs = _segments(rows, splits)
        if order is not None:
            segs = [segs[i] for i in order]
        return run_spec_over_segments(spec_factory, segs, mesh,
                                      delim=delim, merge_at=merge_at)

    for seed in seeds:
        rng = random.Random(seed)
        rep = AlgebraReport(name, seed, mesh_desc)
        reports.append(rep)
        try:
            whole = run([])
        except ChunkedEncodeUnsupported as exc:
            rep.withdrawn = str(exc)
            continue
        splits = _split_points(rng, len(rows), n_splits)
        if not splits:
            # no legal split point: every check below would degenerate
            # to run([]) == run([]) — report the vacuity loudly rather
            # than a clean-looking no-op (review finding)
            rep.withdrawn = (
                f"too few rows to split ({len(rows)} < "
                f"{2 * MIN_CHUNK_ROWS + 1}): nothing verified")
            continue
        rep.splits = splits

        # fold(A ++ B) == fold over randomized chunk boundaries
        try:
            split_out = run(splits)
            ok = split_out == whole
        except ChunkedEncodeUnsupported as exc:
            ok, split_out = True, None
            rep.add("split-invariance", True,
                    f"withdrawn at these splits: {exc}")
        else:
            rep.add("split-invariance", ok,
                    "" if ok else
                    f"{len(whole)} whole lines vs {len(split_out)} "
                    f"split lines differ")
        if not ok:
            rep.shrunk = _shrink(
                splits, lambda s: _differs(run, s, whole))

        # merge(fold(A), fold(B)) == fold(A ++ B)  (the psum claim)
        if not host_only:
            mid = max(1, len(splits) // 2 + 1)
            try:
                merged_out = run(splits, merge_at=mid)
                ok = merged_out == whole
                rep.add("carry-merge", ok,
                        ("device-carry monoid under the single-scan "
                         "host-state contract") if ok else
                        f"merged two carries at segment {mid}: "
                        f"output differs from the whole-stream fold")
            except ChunkedEncodeUnsupported as exc:
                rep.add("carry-merge", True,
                        f"withdrawn at these splits: {exc}")
        else:
            rep.add("carry-merge", True,
                    "host-only spec: no device carry to merge (encode "
                    "buffers fold on host at finalize)")

        # chunk-boundary permutation invariance (order-insensitive:
        # discovery-ordered labels may reorder lines, never change them)
        if splits:
            n_seg = len(_segments(rows, splits))
            order = list(range(n_seg))
            rng.shuffle(order)
            try:
                perm_out = run(splits, order=order)
                ok = sorted(perm_out) == sorted(whole)
                rep.add("chunk-permutation", ok,
                        "" if ok else
                        f"permuted chunk order {order} changes the "
                        f"emitted line set")
            except ChunkedEncodeUnsupported as exc:
                rep.add("chunk-permutation", True,
                        f"withdrawn under permutation: {exc}")
    return reports


def _differs(run, splits, whole) -> bool:
    try:
        return run(splits) != whole
    except ChunkedEncodeUnsupported:
        return False


def _shrink(splits: List[int], fails: Callable[[List[int]], bool]
            ) -> List[int]:
    """Greedy delta-debugging: drop split points one at a time while
    the failure persists; the survivor list is a minimal reproducer."""
    cur = list(splits)
    changed = True
    while changed and len(cur) > 1:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            if fails(cand):
                cur = cand
                changed = True
                break
    return cur


# ---------------------------------------------------------------------------
# snapshot / histogram merge properties
# ---------------------------------------------------------------------------

def _gen_metric_events(rng: random.Random, n: int) -> List[tuple]:
    """Deterministic metric events whose floats are dyadic rationals
    (k/1024): histogram totals sum EXACTLY in any association order, so
    merge equality is byte-exact, not approximate."""
    events = []
    groups = ("Ingest", "Serve", "Drift")
    hists = ("e2e", "queue.wait", "fold")
    gauges = ("depth", "hbm.bytes")
    for i in range(n):
        kind = rng.randrange(3)
        if kind == 0:
            events.append(("ctr", rng.choice(groups),
                           f"c{rng.randrange(4)}", rng.randrange(1, 5)))
        elif kind == 1:
            val = rng.randrange(1, 1 << 20) / 1024.0
            trace = (f"t{i:05d}" if rng.random() < 0.3 else None)
            events.append(("hist", rng.choice(hists), val, trace,
                           1000.0 + i))          # strictly increasing ts
        else:
            events.append(("gauge", rng.choice(gauges),
                           float(rng.randrange(0, 1 << 16)),
                           2000.0 + i))
    return events


def _apply_events(m: Metrics, events: Sequence[tuple]) -> None:
    for e in events:
        if e[0] == "ctr":
            m.counters.incr(e[1], e[2], e[3])
        elif e[0] == "hist":
            m.histogram(e[1]).record(e[2], trace_id=e[3], ts=e[4])
        else:
            m.set_gauge(e[1], e[2], ts=e[3])


def _normalize(snap: dict) -> dict:
    """A merge-comparable snapshot view: the per-process identity and
    capture-time stamps stripped (``ts``/``mono`` are max-combined by
    design; ``pid`` is documented non-merged)."""
    return {"counters": snap.get("counters") or {},
            "gauges": snap.get("gauges") or {},
            "hists": snap.get("hists") or {}}


def verify_snapshot_merge(seed: int, parts: int = 4,
                          events: int = 400) -> AlgebraReport:
    """``merge_snapshots`` is a commutative, associative monoid action
    whose fold over per-part registries equals the single-registry run
    — checked with exact equality on a seeded event stream."""
    rng = random.Random(seed)
    rep = AlgebraReport("merge_snapshots", seed, "host")
    evs = _gen_metric_events(rng, events)
    whole = Metrics()
    _apply_events(whole, evs)
    want = _normalize(whole.mergeable_snapshot())

    cuts = sorted(rng.sample(range(1, len(evs)), parts - 1))
    bounds = [0] + cuts + [len(evs)]
    rep.splits = cuts
    regs = []
    for a, b in zip(bounds, bounds[1:]):
        m = Metrics()
        _apply_events(m, evs[a:b])
        regs.append(m.mergeable_snapshot())

    merged = _normalize(functools.reduce(telemetry.merge_snapshots, regs))
    rep.add("merge == single-run", merged == want,
            "" if merged == want else
            json.dumps({"merged": merged, "want": want})[:400])

    perm = list(regs)
    rng.shuffle(perm)
    commuted = _normalize(functools.reduce(telemetry.merge_snapshots,
                                           perm))
    rep.add("commutativity", commuted == want)

    if len(regs) >= 4:
        left = telemetry.merge_snapshots(regs[0], regs[1])
        right = functools.reduce(telemetry.merge_snapshots, regs[2:])
        assoc = _normalize(telemetry.merge_snapshots(left, right))
        rep.add("associativity", assoc == want)
    return rep


def verify_histogram_merge(seed: int, parts: int = 4,
                           events: int = 500) -> AlgebraReport:
    """``LatencyHistogram.merge`` over per-part histograms equals the
    single histogram, including exemplar retention — exact equality."""
    rng = random.Random(seed)
    rep = AlgebraReport("LatencyHistogram.merge", seed, "host")
    samples = [(rng.randrange(1, 1 << 20) / 1024.0,
                f"t{i:05d}" if rng.random() < 0.25 else None,
                3000.0 + i)
               for i in range(events)]
    whole = LatencyHistogram()
    for v, t, ts in samples:
        whole.record(v, trace_id=t, ts=ts)
    want = whole.state_dict()

    cuts = sorted(rng.sample(range(1, len(samples)), parts - 1))
    bounds = [0] + cuts + [len(samples)]
    rep.splits = cuts
    hists = []
    for a, b in zip(bounds, bounds[1:]):
        h = LatencyHistogram()
        for v, t, ts in samples[a:b]:
            h.record(v, trace_id=t, ts=ts)
        hists.append(h)

    merged = LatencyHistogram()
    for h in hists:
        merged.merge(h)
    got = merged.state_dict()
    rep.add("merge == single-run", got == want)

    rev = LatencyHistogram()
    for h in reversed(hists):
        rev.merge(h)
    rep.add("commutativity", rev.state_dict() == want)

    rt = LatencyHistogram.from_state(want).state_dict()
    rep.add("state round-trip", rt == want)
    return rep


# ---------------------------------------------------------------------------
# the canned verification workload (the registered exporters)
# ---------------------------------------------------------------------------

NB_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["red", "green", "blue"]},
    {"name": "amount", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "bucketWidth": 7},
    {"name": "score", "ordinal": 3, "dataType": "int", "feature": True},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}

MI_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["red", "green", "blue"]},
    {"name": "amount", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "bucketWidth": 7},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}

STATES = ["A", "B", "C"]


def verification_rows(n: int = 240, seed: int = 5) -> List[str]:
    """Deterministic CSV rows: integer-valued numerics (float sums stay
    exact in any chunk order), with every categorical value, class label
    and Markov state in the FIRST rows, so first-chunk cap sizing holds at
    any split point past MIN_CHUNK_ROWS."""
    rng = np.random.default_rng(seed)
    colors = ("red", "green", "blue")
    rows = []
    # the coverage preamble: every (color, label) pair and every state
    for i, (c, lbl) in enumerate([(c, l) for c in colors
                                  for l in ("N", "Y")]):
        seq = [STATES[(i + k) % 3] for k in range(4)]
        rows.append(",".join([f"id{i:05d}", c, str(7 * i % 100),
                              str(i - 3), lbl] + seq))
    for i in range(len(rows), n):
        c = colors[int(rng.integers(len(colors)))]
        amt = int(rng.integers(0, 100))
        score = int(rng.integers(-40, 60))
        lbl = "Y" if (c == "red") ^ (amt > 55) ^ (rng.random() < 0.2) \
            else "N"
        seq = [STATES[int(rng.integers(3))] for _ in range(4)]
        rows.append(",".join([f"id{i:05d}", c, str(amt), str(score),
                              lbl] + seq))
    return rows


def verification_jobs(work_dir: str) -> Dict[str, tuple]:
    """jid -> (job class, per-job props) for every exporter of a
    FoldSpec in the port's job registry, over one shared workload written
    under ``work_dir``."""
    from .io import atomic_write_text

    nb_schema = os.path.join(work_dir, "nb_schema.json")
    mi_schema = os.path.join(work_dir, "mi_schema.json")
    if not os.path.exists(nb_schema):
        atomic_write_text(nb_schema, json.dumps(NB_SCHEMA))
        atomic_write_text(mi_schema, json.dumps(MI_SCHEMA))
    return {
        "nb": ("BayesianDistribution",
               {"feature.schema.file.path": nb_schema}),
        "mi": ("MutualInformation",
               {"feature.schema.file.path": mi_schema}),
        "corr": ("CramerCorrelation",
                 {"feature.schema.file.path": mi_schema,
                  "source.attributes": "1", "dest.attributes": "4"}),
        "het": ("HeterogeneityReductionCorrelation",
                {"feature.schema.file.path": mi_schema,
                 "source.attributes": "1", "dest.attributes": "4"}),
        "mst": ("MarkovStateTransitionModel",
                {"model.states": ",".join(STATES),
                 "skip.field.count": "5"}),
        "stats": ("NumericalAttrStats",
                  {"attr.list": "2,3", "cond.attr.ord": "4"}),
        # the bandit posterior fold: the workload's columns as reward
        # events, color as tenant, label as arm, the integer score as
        # reward
        "bandit_fb": ("BanditFeedbackAggregator",
                      {"stream.tenants": "red,green,blue",
                       "stream.arms": "N,Y",
                       "stream.tenant.ordinal": "1",
                       "stream.arm.ordinal": "4",
                       "stream.reward.ordinal": "3"}),
    }


def spec_factory(jid: str, work_dir: str, device=None
                 ) -> Callable[[], object]:
    """A zero-argument factory building a FRESH FoldSpec for the canned
    ``jid`` (a fresh job on ``device``, fresh encoder and stream state)
    writing to a per-jid output directory: every verification run starts
    from a clean slate."""
    from ..cli import job_class, resolve
    from .config import JobConfig

    cls_name, props = verification_jobs(work_dir)[jid]
    cls, prefix = job_class(cls_name), resolve(cls_name)[2]
    out_path = os.path.join(work_dir, f"out_{jid}")

    def make():
        job = cls(JobConfig(dict(props), prefix), device=device)
        spec = job.fold_spec(out_path)
        if spec is None:
            raise ValueError(f"{cls_name} exports no FoldSpec under the "
                             f"verification config")
        return spec

    return make


def registered_exporters() -> Dict[str, type]:
    """Every job class of the port's registry that exports
    ``fold_spec``: the coverage closure, so a NEW exporter must gain a
    verification workload (``verification_jobs``) or :func:`run_dynamic`
    fails."""
    from ..cli import JOBS, job_class

    out = {}
    for fqcn in sorted(JOBS):
        cls = job_class(fqcn)
        if callable(getattr(cls, "fold_spec", None)):
            out[cls.__name__] = cls
    return out


def run_dynamic(seeds: Sequence[int] = DEFAULT_SEEDS,
                log: Optional[Callable[[str], None]] = None,
                mesh=None) -> List[AlgebraReport]:
    """The whole certificate: every registered FoldSpec exporter on
    ``mesh`` (default ``parallel.mesh.get_mesh()``, every visible card)
    plus the snapshot and histogram merges; every report (a caller fails
    on any ``failed``)."""
    from ..parallel.mesh import get_mesh

    def say(msg):
        if log is not None:
            log(msg)

    mesh = mesh or get_mesh()
    device = mesh.devices.flat[0]
    reports: List[AlgebraReport] = []
    with tempfile.TemporaryDirectory(prefix="avenir-algebra-") as wd:
        jobs = verification_jobs(wd)
        covered = {cls for cls, _ in jobs.values()}
        missing = sorted(set(registered_exporters()) - covered)
        if missing:
            rep = AlgebraReport("coverage", 0, "n/a")
            rep.add("every exporter has a verification workload", False,
                    f"no canned workload for FoldSpec exporter(s) "
                    f"{missing}: add them to "
                    f"core.algebra.verification_jobs")
            reports.append(rep)
        rows = verification_rows()
        say(f"algebra: verifying {len(jobs)} specs over "
            f"{len(rows)} rows on {mesh!r}, seeds={list(seeds)}")
        for jid in jobs:
            reps = verify_fold_spec(spec_factory(jid, wd, device), rows,
                                    mesh, seeds=seeds, spec_name=jid)
            reports.extend(reps)
            for r in reps:
                say(r.format())
    for seed in seeds:
        for rep in (verify_snapshot_merge(seed),
                    verify_histogram_merge(seed)):
            reports.append(rep)
            say(rep.format())
    return reports
