"""Production telemetry: periodic export, Prometheus exposition, compile
and device-memory profiling, and count-distribution drift gauges.

The port's copy of ``avenir_tpu/core/telemetry.py``, with its two
device hooks written anew for PyTorch (:func:`profiled_build`,
:func:`sample_device_memory`).  core.obs holds the in-process substrate
— spans, mergeable histograms, a ``Metrics`` registry; this module is
the operational layer on top (the TF-Serving/INFaaS premise from PAPERS.md —
a served model you cannot scrape, alert on, or profile is not
production-grade):

- **Process-global registry** — :func:`get_metrics` is the one
  ``Metrics`` every subsystem feeds (compile counters, device-memory
  gauges, drift gauges, serving overlays); the exporter snapshots it.
- **Periodic exporter** (:class:`TelemetryExporter`) — a background
  thread snapshotting the registry every ``telemetry.interval.sec``
  into an append-only JSONL time-series file (``--metrics-out`` on
  every batch job, ``telemetry.jsonl.path`` on serve).  Snapshots are
  MERGEABLE across processes (:func:`merge_snapshots`: histogram bucket
  counts add, monotonic counters sum, gauges latest-timestamp-wins), so
  multi-host aggregation is a fold, not a redesign.
- **Prometheus text exposition** (:func:`prometheus_text`) — the same
  snapshot rendered in the text exposition format any scraper parses
  (the serve frontend's ``metrics`` command; terminated by ``# EOF``).
- **Profiling hooks** — :func:`profiled_build` bills the first call of
  a built scorer (the port's "compile": PyTorch runs eagerly) to an
  ``xla.compile`` span + the cumulative ``Telemetry / xla.compile.ms``
  counter, the names the reference's stats surface uses;
  :func:`sample_device_memory` samples ``torch.cuda.memory_allocated``
  on the watched cards into a ``device.hbm.bytes`` gauge, rate-limited
  for per-chunk/per-batch call sites.
- **Drift gauges** — :func:`count_drift` (symmetrised KL over smoothed
  count distributions) feeds per-feature ``drift.<feature>`` gauges
  when a re-scan trains against a stored baseline count table
  (``telemetry.drift.baseline.path`` on the NB trainer) — the concrete
  sensor a retrain trigger consumes.
- **Incremental trace flush** (:class:`TraceFlusher`) — with
  ``obs.trace.flush.interval.sec`` set, ``--trace`` no longer exports
  only at exit: new span records append to the trace path as JSONL
  every interval, rotating (``out.json.1``, …) past
  ``obs.trace.flush.max.bytes``, so a crashed or long-running job still
  yields a usable trace prefix.

Config surface (the .properties files every job loads; README
"Telemetry & SLOs"):

- ``telemetry.interval.sec``             — exporter tick period
  (default 10; <= 0 disables the thread)
- ``telemetry.jsonl.path``               — append-only JSONL series
  destination (the ``--metrics-out`` CLI flag sets it)
- ``telemetry.device.sample.interval.sec`` — min seconds between
  device-memory samples (default 1.0; <= 0 disables sampling)
- ``telemetry.drift.baseline.path``      — stored baseline NB model
  whose count tables the current fold is diffed against
- ``obs.trace.flush.interval.sec``       — periodic trace flush period
  (default 0 = exit-only export, the pre-PR behavior)
- ``obs.trace.flush.max.bytes``          — rotate the flushed trace
  past this size (default 32 MiB)
- ``obs.trace.flush.keep``               — rotated files kept (default 3)
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

from . import obs, sanitizer
from .obs import Metrics

KEY_INTERVAL = "telemetry.interval.sec"
KEY_JSONL_PATH = "telemetry.jsonl.path"
KEY_DEVICE_SAMPLE = "telemetry.device.sample.interval.sec"
KEY_DRIFT_BASELINE = "telemetry.drift.baseline.path"
KEY_FLUSH_INTERVAL = "obs.trace.flush.interval.sec"
KEY_FLUSH_MAX_BYTES = "obs.trace.flush.max.bytes"
KEY_FLUSH_KEEP = "obs.trace.flush.keep"

DEFAULT_INTERVAL_SEC = 10.0
DEFAULT_DEVICE_SAMPLE_SEC = 1.0
DEFAULT_FLUSH_MAX_BYTES = 32 << 20
DEFAULT_FLUSH_KEEP = 3

TELEMETRY_GROUP = "Telemetry"
COMPILE_MS = "xla.compile.ms"
COMPILE_COUNT = "xla.compiles"

SNAPSHOT_VERSION = 1

#: thread-name prefixes of every thread this module may start — the
#: shutdown lint (tests/test_obs_coverage.py) asserts none survive stop()
THREAD_PREFIXES = ("avenir-telemetry", "avenir-trace-flush")


# ---------------------------------------------------------------------------
# the process-global registry
# ---------------------------------------------------------------------------

_GLOBAL_METRICS = Metrics()


def get_metrics() -> Metrics:
    """The process-global Metrics registry: compile counters, device
    gauges, drift gauges — everything the periodic exporter snapshots."""
    return _GLOBAL_METRICS


def set_metrics(m: Metrics) -> Metrics:
    global _GLOBAL_METRICS
    _GLOBAL_METRICS = m
    return m


# ---------------------------------------------------------------------------
# mergeable snapshots
# ---------------------------------------------------------------------------

def build_snapshot(registry: Optional[Metrics] = None,
                   tracer=None,
                   identity: Optional[Mapping[str, object]] = None) -> dict:
    """One timestamped, mergeable snapshot: the registry's counters +
    histogram bucket states + stamped gauges, plus the tracer's per-name
    span summaries and breaker-visible tracer stats.

    ``identity`` (optional) stamps a process identity record — role,
    host, pid, start-time nonce (see ``fleetobs.identity``) — so a
    fleet aggregator can attribute the snapshot to its publishing
    process.  Like ``pid``, the section is deliberately NOT carried
    through ``merge_snapshots`` (SNAPSHOT_NON_MERGED)."""
    registry = registry if registry is not None else get_metrics()
    tracer = tracer if tracer is not None else obs.get_tracer()
    snap = registry.mergeable_snapshot()
    snap["v"] = SNAPSHOT_VERSION
    snap["pid"] = os.getpid()
    snap["spans"] = tracer.span_summaries()
    if identity is not None:
        snap["identity"] = dict(identity)
    return snap


def merge_exemplar_states(a: Optional[dict], b: Optional[dict]) -> dict:
    """Latest-timestamp-wins per-bucket merge of two ``state_dict``-form
    exemplar maps (``{bucket: {"trace_id", "value", "ts"}}``) — the ONE
    rule, shared by snapshot merging here and the replica-pool histogram
    aggregation (serve.pool.merged_hist_state).

    Exact-timestamp ties break on (trace_id, value), NOT insertion side:
    the old ``b wins ties`` rule made the merge order-dependent when two
    processes stamped the same clock value, which the split-invariance
    verifier (core.algebra) flags as a commutativity violation."""
    out = dict(a or {})
    for i, e in (b or {}).items():
        cur = out.get(i)
        if cur is None or ((e["ts"], str(e["trace_id"]), e["value"])
                           > (cur["ts"], str(cur["trace_id"]),
                              cur["value"])):
            out[i] = e
    return out


def _merge_hist_state(a: dict, b: dict) -> dict:
    """Bucket-wise add of two histogram state dicts (same ladder);
    exemplars keep the latest-timestamped trace per bucket."""
    for k in ("n_buckets", "lo", "hi"):
        if a[k] != b[k]:
            raise ValueError(
                f"cannot merge histogram states with different bucket "
                f"ladders ({k}: {a[k]} vs {b[k]})")
    counts = dict(a.get("counts", {}))
    for i, c in b.get("counts", {}).items():
        counts[i] = counts.get(i, 0) + c
    n = a["n"] + b["n"]
    out = {"n_buckets": a["n_buckets"], "lo": a["lo"], "hi": a["hi"],
           "counts": counts, "n": n, "total": a["total"] + b["total"],
           "vmin": None, "vmax": None}
    vmins = [s["vmin"] for s in (a, b) if s["n"]]
    vmaxs = [s["vmax"] for s in (a, b) if s["n"]]
    if n:
        out["vmin"] = min(vmins)
        out["vmax"] = max(vmaxs)
    ex = merge_exemplar_states(a.get("exemplars"), b.get("exemplars"))
    if ex:
        out["exemplars"] = ex
    return out


#: snapshot sections DELIBERATELY absent from a merged snapshot, with
#: the reason — the merge-closure rule (avenir-analyze) fails on any
#: section the builders write that is neither merged nor listed here,
#: so a new snapshot field can never be silently dropped by the
#: multi-host fold.
SNAPSHOT_NON_MERGED: Dict[str, str] = {
    "pid":
        "process identity: a merged snapshot spans processes by "
        "definition, so carrying one pid forward would be a lie — "
        "consumers needing lineage read the per-process JSONL lines",
    "identity":
        "fleet process identity record (role/host/pid/start nonce): a "
        "merged snapshot spans processes, so no single identity is "
        "true of it — the fleet fold (fleetobs.aggregate) consumes the "
        "record BEFORE merging (per-process gauge namespacing, feed "
        "staleness attribution) and then drops it, exactly like pid",
}

#: every top-level section merge_snapshots knows how to carry; an input
#: section outside this set (and SNAPSHOT_NON_MERGED) raises so schema
#: growth is loud at the merge point too, not only in static analysis
SNAPSHOT_SECTIONS = frozenset(
    {"v", "ts", "mono", "counters", "gauges", "hists", "spans",
     "resilience"})


def merge_resilience(a: Optional[dict], b: Optional[dict]) -> dict:
    """Max-fold of two ``resilience`` sections — the serve layer's
    breaker state codes (``{"breakers": {model: 0/1/2}}``) and
    quarantined poison-row signatures
    (``{"quarantine": {model: {sig: offenses}}}``).

    Both halves fold by per-key ``max``: a breaker tripped ANYWHERE in
    the fleet must survive the fold (the router pre-demotes on it), and
    a signature's offense count only ever grows, so max is the honest
    union.  Max over non-negative ints with identity 0 is a commutative
    monoid, keeping ``merge_snapshots`` certified-commutative."""
    out = {"breakers": dict((a or {}).get("breakers") or {}),
           "quarantine": {m: dict(sigs or {}) for m, sigs in
                          ((a or {}).get("quarantine") or {}).items()}}
    for model, code in ((b or {}).get("breakers") or {}).items():
        out["breakers"][model] = max(int(out["breakers"].get(model, 0)),
                                     int(code or 0))
    for model, sigs in ((b or {}).get("quarantine") or {}).items():
        dst = out["quarantine"].setdefault(model, {})
        for sig, n in (sigs or {}).items():
            dst[sig] = max(int(dst.get(sig, 0)), int(n or 0))
    return out


def merge_snapshots(a: dict, b: dict) -> dict:
    """Fold two mergeable snapshots into one: counters sum, histogram
    buckets add, gauges latest-timestamp-wins (value breaks exact-ts
    ties deterministically, keeping the merge commutative), span
    summaries count-weighted-sum.  Associative and commutative, and a
    merge of per-process snapshots equals the single-process run
    (asserted in tests/test_telemetry.py) — multi-host aggregation is
    ``functools.reduce(merge_snapshots, snaps)`` over ONE snapshot per
    process (each JSONL line is cumulative for its process, so fold
    each process's latest line, not the whole series).

    An unknown top-level section in either input raises ``ValueError``
    naming the field: silently dropping a section a newer writer added
    is exactly the corruption mode the merge-closure rule exists to
    prevent, and the runtime guard keeps mixed-version fleets honest.
    """
    for snap in (a, b):
        unknown = sorted(set(snap) - SNAPSHOT_SECTIONS
                         - set(SNAPSHOT_NON_MERGED))
        if unknown:
            raise ValueError(
                f"merge_snapshots: unknown snapshot section(s) "
                f"{unknown} — extend the merge (and SNAPSHOT_SECTIONS) "
                f"or document the drop in SNAPSHOT_NON_MERGED")
    counters: Dict[str, Dict[str, int]] = {}
    for snap in (a, b):
        for g, names in (snap.get("counters") or {}).items():
            dst = counters.setdefault(g, {})
            for n, v in names.items():
                dst[n] = dst.get(n, 0) + v

    gauges: Dict[str, dict] = dict(a.get("gauges") or {})
    for name, g in (b.get("gauges") or {}).items():
        cur = gauges.get(name)
        if cur is None or (g["ts"], g["value"]) > (cur["ts"], cur["value"]):
            gauges[name] = g

    hists: Dict[str, dict] = dict(a.get("hists") or {})
    for name, st in (b.get("hists") or {}).items():
        hists[name] = (_merge_hist_state(hists[name], st)
                       if name in hists else st)

    spans: Dict[str, dict] = {k: dict(v)
                              for k, v in (a.get("spans") or {}).items()}
    for name, s in (b.get("spans") or {}).items():
        cur = spans.get(name)
        if cur is None:
            spans[name] = dict(s)
        else:
            cur["count"] += s["count"]
            cur["total_ms"] += s["total_ms"]
            cur["mean_ms"] = (cur["total_ms"] / cur["count"]
                              if cur["count"] else 0.0)

    out = {"v": SNAPSHOT_VERSION,
           "ts": max(a.get("ts", 0.0), b.get("ts", 0.0)),
           "mono": max(a.get("mono", 0.0), b.get("mono", 0.0)),
           "counters": counters, "gauges": gauges, "hists": hists,
           "spans": spans}
    if "resilience" in a or "resilience" in b:
        # present only when an input carried it: batch jobs and routers
        # never export the section, and their merged snapshots must stay
        # byte-identical to the pre-section shape
        out["resilience"] = merge_resilience(a.get("resilience"),
                                             b.get("resilience"))
    return out


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABELED_RE = re.compile(r"^([^{]+)\{(.*)\}$")


def _family(name: str):
    """Split a metric name into (sanitized family, label string).  Names
    may carry Prometheus-style labels inline — ``serve.e2e{model="c"}``
    — which pass through; the family part sanitizes to the exposition
    charset."""
    m = _LABELED_RE.match(name)
    base, labels = (m.group(1), m.group(2)) if m else (name, "")
    fam = _NAME_RE.sub("_", base.strip("."))
    if fam and fam[0].isdigit():
        fam = "_" + fam
    return fam, labels


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def labeled(name: str, **labels) -> str:
    """Attach Prometheus-style labels to a metric name with proper label
    escaping — the ONE way callers should build labeled gauge/histogram
    names (a model name containing a quote or backslash must not produce
    unparseable exposition lines)."""
    inner = ",".join(f'{k}="{_esc(str(v))}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}" if inner else name


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(snapshot: dict, prefix: str = "avenir") -> str:
    """Render a mergeable snapshot in the Prometheus text exposition
    format (one TYPE line per family, counters as ``_total``, histograms
    with cumulative ``le`` buckets + ``_sum``/``_count``), terminated by
    ``# EOF`` so a line-oriented client knows where the scrape ends.
    Golden-parsed by a scraper-grade parser in tests/test_telemetry.py."""
    out = []

    ctrs = snapshot.get("counters") or {}
    if ctrs:
        fam = f"{prefix}_counter_total"
        out.append(f"# HELP {fam} Job/serve counters (group, name labels).")
        out.append(f"# TYPE {fam} counter")
        for g in sorted(ctrs):
            for n in sorted(ctrs[g]):
                out.append(f'{fam}{{group="{_esc(g)}",name="{_esc(n)}"}} '
                           f"{_fmt(ctrs[g][n])}")

    by_fam: Dict[str, list] = {}
    for name, g in sorted((snapshot.get("gauges") or {}).items()):
        fam, labels = _family(name)
        by_fam.setdefault(fam, []).append((labels, g["value"]))
    for fam in sorted(by_fam):
        full = f"{prefix}_{fam}"
        out.append(f"# TYPE {full} gauge")
        for labels, v in by_fam[fam]:
            out.append(f"{full}{{{labels}}} {_fmt(v)}" if labels
                       else f"{full} {_fmt(v)}")

    hist_fams: Dict[str, list] = {}
    for name, st in sorted((snapshot.get("hists") or {}).items()):
        fam, labels = _family(name)
        hist_fams.setdefault(fam, []).append((labels, st))
    for fam in sorted(hist_fams):
        full = f"{prefix}_{fam}_seconds"
        out.append(f"# TYPE {full} histogram")
        for labels, st in hist_fams[fam]:
            lbl = labels + "," if labels else ""
            bounds = obs._log_bounds(st["n_buckets"], st["lo"], st["hi"])
            counts = st.get("counts", {})
            exemplars = st.get("exemplars") or {}

            def _exemplar_suffix(i):
                # OpenMetrics exemplar: ` # {trace_id="..."} value ts` —
                # the last sampled trace that landed in the bucket, so a
                # bad tail bucket links straight to a trace to open.
                # The retained value lies inside its bucket by
                # construction (the OpenMetrics validity rule).
                e = exemplars.get(str(i))
                if not e:
                    return ""
                return (f' # {{trace_id="{_esc(str(e["trace_id"]))}"}} '
                        f'{_fmt(e["value"])} {_fmt(round(e["ts"], 3))}')

            cum = 0
            for i in range(st["n_buckets"] + 2):
                c = counts.get(str(i), 0)
                if not c:
                    continue
                cum += c
                # sparse cumulative buckets: one le edge per bucket that
                # holds samples (+Inf below always closes the series)
                if i <= st["n_buckets"]:
                    edge = bounds[i] if i < len(bounds) else bounds[-1]
                    out.append(f'{full}_bucket{{{lbl}le="{_fmt(edge)}"}} '
                               f"{cum}" + _exemplar_suffix(i))
            out.append(f'{full}_bucket{{{lbl}le="+Inf"}} {st["n"]}'
                       + _exemplar_suffix(st["n_buckets"] + 1))
            out.append(f"{full}_sum{{{labels}}} {_fmt(st['total'])}"
                       if labels else f"{full}_sum {_fmt(st['total'])}")
            out.append(f"{full}_count{{{labels}}} {st['n']}"
                       if labels else f"{full}_count {st['n']}")

    spans = snapshot.get("spans") or {}
    if spans:
        # gauges, NOT counters: summaries aggregate the tracer's bounded
        # ring buffer, so a value may DROP between scrapes once the
        # buffer rotates — typing them counter would make rate() read
        # every rotation as a counter reset
        cfam = f"{prefix}_span_count"
        mfam = f"{prefix}_span_ms"
        out.append(f"# TYPE {cfam} gauge")
        for name in sorted(spans):
            out.append(f'{cfam}{{name="{_esc(name)}"}} '
                       f"{spans[name]['count']}")
        out.append(f"# TYPE {mfam} gauge")
        for name in sorted(spans):
            out.append(f'{mfam}{{name="{_esc(name)}"}} '
                       f"{_fmt(spans[name]['total_ms'])}")

    out.append("# EOF")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# build + device-memory profiling hooks
# ---------------------------------------------------------------------------

def profiled_build(fun: Callable, label: str) -> Callable:
    """Build accounting for a scorer: the port's counterpart of the
    reference's ``profiled_jit``.  PyTorch runs eagerly, so there is no
    XLA compile; the "compile" of a built scorer is its FIRST call, which
    brings up the device context, loads the kernels and fills the caching
    allocator at that shape.  That call's wall time is billed to an
    ``xla.compile`` span and the cumulative ``Telemetry / xla.compile.ms``
    and ``Telemetry / xla.compiles`` counters, the names the stats
    surface already reads, so a client of the reference reads the port's
    surface unchanged.  Later calls cost one flag check.

    The wrapper holds no buffers: it is a plain function of its
    arguments, so replicas and tenants that share it through the compile
    tier can call it concurrently."""
    lock = threading.Lock()
    state = {"built": False}

    def wrapped(*args, **kwargs):
        if state["built"]:
            return fun(*args, **kwargs)
        t0 = time.perf_counter_ns()
        out = fun(*args, **kwargs)
        with lock:
            first = not state["built"]
            state["built"] = True
        if first:
            dur = time.perf_counter_ns() - t0
            m = get_metrics()
            m.counters.incr(TELEMETRY_GROUP, COMPILE_COUNT)
            m.counters.incr(TELEMETRY_GROUP, COMPILE_MS,
                            max(int(round(dur / 1e6)), 1))
            tr = obs.get_tracer()
            if tr.enabled:
                tr.record_span("xla.compile", t0, dur, label=label)
        return out

    wrapped.__wrapped__ = fun
    wrapped.__profiled_label__ = label
    return wrapped


_DEVICE_SAMPLE = {"last": 0.0, "interval": DEFAULT_DEVICE_SAMPLE_SEC,
                  "lock": threading.Lock(), "devices": []}


def set_device_sample_interval(seconds: float) -> None:
    """Rate limit for :func:`sample_device_memory` (<= 0 disables)."""
    _DEVICE_SAMPLE["interval"] = float(seconds)


def watch_device(device) -> None:
    """Add a CUDA device to the ones :func:`sample_device_memory` sums
    (the serving pool registers each replica's card); CPU devices hold
    no device memory and are ignored."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    with _DEVICE_SAMPLE["lock"]:
        if dev not in _DEVICE_SAMPLE["devices"]:
            _DEVICE_SAMPLE["devices"].append(dev)


def sample_device_memory(registry: Optional[Metrics] = None,
                         force: bool = False) -> Optional[int]:
    """Sample device-memory residency into the ``device.hbm.bytes`` gauge
    (the reference's name; + a tracer counter series when tracing):
    ``torch.cuda.memory_allocated`` summed over the watched CUDA devices
    (:func:`watch_device`).  Rate-limited to
    ``telemetry.device.sample.interval.sec`` so per-batch call sites stay
    cheap; returns the sampled byte count, or None when skipped or when
    no CUDA device is watched (a CPU run)."""
    interval = _DEVICE_SAMPLE["interval"]
    if interval <= 0 and not force:
        return None
    now = time.monotonic()
    with _DEVICE_SAMPLE["lock"]:
        if not force and now - _DEVICE_SAMPLE["last"] < interval:
            return None
        _DEVICE_SAMPLE["last"] = now
        devices = list(_DEVICE_SAMPLE["devices"])
    if not devices:
        return None
    import torch
    total = sum(int(torch.cuda.memory_allocated(d)) for d in devices)
    reg = registry if registry is not None else get_metrics()
    reg.set_gauge("device.hbm.bytes", total)
    tr = obs.get_tracer()
    if tr.enabled:
        tr.gauge("device.hbm.bytes", total)
    return total


# ---------------------------------------------------------------------------
# count-distribution drift
# ---------------------------------------------------------------------------

def count_drift(baseline: Mapping[str, float], current: Mapping[str, float],
                smooth: float = 0.5) -> float:
    """Symmetrised KL divergence between two count distributions over
    the union of their supports, with add-``smooth`` smoothing so a bin
    present on only one side contributes finitely.  0.0 means identical
    distributions; the value grows with distribution shift — the scalar
    a retrain trigger thresholds."""
    keys = set(baseline) | set(current)
    if not keys:
        return 0.0
    k = len(keys)
    nb = sum(max(float(v), 0.0) for v in baseline.values()) + smooth * k
    nc = sum(max(float(v), 0.0) for v in current.values()) + smooth * k
    if nb <= 0 or nc <= 0:
        return 0.0
    d = 0.0
    for key in keys:
        p = (max(float(baseline.get(key, 0.0)), 0.0) + smooth) / nb
        q = (max(float(current.get(key, 0.0)), 0.0) + smooth) / nc
        d += 0.5 * (p * math.log(p / q) + q * math.log(q / p))
    return d


# ---------------------------------------------------------------------------
# the periodic exporter
# ---------------------------------------------------------------------------

class TelemetryExporter:
    """Background thread snapshotting the registry every ``interval_sec``
    into an append-only JSONL time-series (one mergeable snapshot per
    line) and/or feeding providers.

    ``providers`` are callables invoked per tick; each may return a
    partial snapshot dict (``gauges``/``hists``/``counters`` sections,
    e.g. the serve layer's per-model latency families + SLO evaluation)
    that overlays the registry snapshot.  ``sinks`` are callables
    invoked per tick with the COMPLETE snapshot (after overlays) —
    additional export destinations beyond the JSONL series, e.g. the
    fleet spool publisher (``fleetobs.publisher``); a raising sink is
    swallowed exactly like a raising provider.  ``identity`` (a
    mapping) stamps every snapshot with a process identity record (see
    :func:`build_snapshot`).  ``stop()`` joins the thread (bounded) and
    takes one final tick so short jobs still export at least one line;
    the thread is verifiably gone afterwards (asserted by the shutdown
    lint)."""

    def __init__(self, interval_sec: float,
                 jsonl_path: Optional[str] = None,
                 registry: Optional[Metrics] = None,
                 tracer=None,
                 providers: Iterable[Callable[[], Optional[dict]]] = (),
                 sinks: Iterable[Callable[[dict], None]] = (),
                 identity: Optional[Mapping[str, object]] = None):
        self.interval = float(interval_sec)
        self.jsonl_path = jsonl_path
        self.registry = registry
        self.tracer = tracer
        self.providers = list(providers)
        self.sinks = list(sinks)
        self.identity = dict(identity) if identity is not None else None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = sanitizer.make_lock("telemetry.exporter")
        self.ticks = 0

    # -- snapshotting ------------------------------------------------------
    def snapshot(self) -> dict:
        """Registry snapshot + provider overlays (no file write) — the
        serve ``metrics`` command renders THIS through
        :func:`prometheus_text`, so a scrape and a JSONL line always
        agree."""
        snap = build_snapshot(self.registry, self.tracer,
                              identity=self.identity)
        for provider in self.providers:
            try:
                extra = provider()
            except Exception:                           # noqa: BLE001
                continue            # a broken provider must not kill export
            if not extra:
                continue
            for section in ("gauges", "hists", "spans"):
                if section in extra:
                    snap.setdefault(section, {}).update(extra[section])
            for g, names in (extra.get("counters") or {}).items():
                dst = snap.setdefault("counters", {}).setdefault(g, {})
                dst.update(names)
            if "resilience" in extra:
                snap["resilience"] = merge_resilience(
                    snap.get("resilience"), extra["resilience"])
        return snap

    def tick(self) -> dict:
        """One export cycle: build the snapshot, append the JSONL line,
        feed every sink."""
        snap = self.snapshot()
        if self.jsonl_path:
            line = json.dumps(snap) + "\n"
            with self._lock:
                with open(self.jsonl_path, "a") as fh:
                    fh.write(line)
        for sink in self.sinks:
            try:
                sink(snap)
            except Exception:                           # noqa: BLE001
                continue        # a broken sink must not kill export
        # under the same lock as the file append: tick() is called by
        # the exporter thread AND by stop()/manual callers, and an
        # unlocked += is exactly the RMW race the lock-discipline rule
        # (avenir-analyze) flags
        with self._lock:
            self.ticks += 1
        return snap

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TelemetryExporter":
        if self.interval <= 0 or self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.tick()
                except Exception:                       # noqa: BLE001
                    # export must never kill the host process; the next
                    # tick retries (e.g. a transiently unwritable path)
                    pass

        self._thread = threading.Thread(target=run, name="avenir-telemetry",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None
        if final_tick and self.jsonl_path:
            try:
                self.tick()
            except Exception:                           # noqa: BLE001
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------------------------
# incremental trace flush
# ---------------------------------------------------------------------------

class TraceFlusher:
    """Periodically appends NEW tracer records to the ``--trace`` path as
    JSONL, rotating past ``max_bytes`` (``path.1`` newest rotation …
    ``path.<keep>`` oldest), so a crashed or still-running job yields a
    usable trace prefix instead of nothing.  The exit-time Chrome-format
    export still overwrites the live path on a clean shutdown."""

    def __init__(self, tracer, path: str, interval_sec: float,
                 max_bytes: int = DEFAULT_FLUSH_MAX_BYTES,
                 keep: int = DEFAULT_FLUSH_KEEP):
        self.tracer = tracer
        self.path = path
        self.interval = float(interval_sec)
        self.max_bytes = int(max_bytes)
        self.keep = max(int(keep), 1)
        self._since = 0
        self.dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # one flush at a time: the flusher thread and a manual caller
        # (or the exit path racing a slow tick) would otherwise
        # interleave _since/dropped updates and duplicate records
        self._lock = sanitizer.make_lock("telemetry.flusher")

    def _rotate(self) -> None:
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")

    def flush(self) -> int:
        """Append records not yet flushed; returns how many were written."""
        with self._lock:
            recs, self._since, dropped = self.tracer.records_since(
                self._since)
            self.dropped += dropped
            if not recs:
                return 0
            if (os.path.exists(self.path)
                    and os.path.getsize(self.path) >= self.max_bytes):
                self._rotate()
            with open(self.path, "a") as fh:
                for r in recs:
                    fh.write(json.dumps(self.tracer.record_dict(r))
                             + "\n")
            return len(recs)

    def start(self) -> "TraceFlusher":
        if self.interval <= 0 or self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.flush()
                except Exception:                       # noqa: BLE001
                    pass

        self._thread = threading.Thread(target=run,
                                        name="avenir-trace-flush",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None


# ---------------------------------------------------------------------------
# config plumbing (the CLI entry points call these next to obs.configure)
# ---------------------------------------------------------------------------

def configure_from_config(config) -> None:
    """Apply the passive telemetry settings (device-memory sample rate)
    — called by every CLI entry point; thread-owning pieces are built
    explicitly via :func:`exporter_for_job` / :func:`flusher_for_job`."""
    set_device_sample_interval(
        config.get_float(KEY_DEVICE_SAMPLE, DEFAULT_DEVICE_SAMPLE_SEC))


def exporter_for_job(config,
                     metrics_out: Optional[str] = None,
                     providers: Iterable[Callable] = ()
                     ) -> Optional[TelemetryExporter]:
    """A STARTED exporter for a batch job/serve process, or None when
    nothing asked for one (no ``--metrics-out`` flag, no
    ``telemetry.jsonl.path`` key, and no providers)."""
    path = metrics_out or config.get(KEY_JSONL_PATH)
    providers = list(providers)
    if not path and not providers:
        return None
    interval = config.get_float(KEY_INTERVAL, DEFAULT_INTERVAL_SEC)
    exp = TelemetryExporter(interval, jsonl_path=path, providers=providers)
    return exp.start()


def flusher_for_job(config, trace_path: Optional[str]
                    ) -> Optional[TraceFlusher]:
    """A STARTED periodic trace flusher when ``--trace`` is active and
    ``obs.trace.flush.interval.sec`` is configured positive."""
    if not trace_path:
        return None
    interval = config.get_float(KEY_FLUSH_INTERVAL, 0.0)
    if interval <= 0:
        return None
    fl = TraceFlusher(
        obs.get_tracer(), trace_path, interval,
        max_bytes=config.get_int(KEY_FLUSH_MAX_BYTES,
                                 DEFAULT_FLUSH_MAX_BYTES),
        keep=config.get_int(KEY_FLUSH_KEEP, DEFAULT_FLUSH_KEEP))
    return fl.start()
