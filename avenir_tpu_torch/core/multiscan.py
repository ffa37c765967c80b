"""Shared-scan job fusion: one streamed ingest pass feeding several fold jobs.

The port's counterpart of ``avenir_tpu/core/multiscan.py``.  avenir's
workflows chain jobs over the same input file (Naive Bayes counts, mutual
information, correlations, Markov transitions, attribute stats), and each
job re-reads and re-parses the input.  This engine reads, parses and copies
each chunk to the device once and hands it to every registered job's fold
(MRShare's scan sharing, Nykiel et al., VLDB 2010), so an N-job workflow
costs about one ingest.

Three layers, as the reference's:

- :class:`FoldSpec`: what a fusable job exports (its
  ``fold_spec(out_path)``): a per-chunk host ``encode`` (on the prefetch
  worker; it may raise ``ChunkedEncodeUnsupported`` to withdraw), the fold
  contract ``local_fn``/``static_args`` of ``core.pipeline.ChunkFold``
  (``static_args`` may be set by the first ``encode``), and ``finalize``,
  which writes the job's normal output file from the folded carry, byte for
  byte a standalone run's.
- :class:`ChunkContext`: one chunk's views, built once and shared: jobs on
  one schema file share one encode and one host-to-device copy a chunk
  (the engine dedupes copies by host-array identity).
- :class:`MultiScanEngine`: the double-buffered scan (``pipeline.
  drive_prefetched`` over ``iter_byte_chunks_meta``), one
  ``ChunkTransfer`` for every spec and one ``ChunkFold`` per spec; the
  per-job ``multiscan.encode`` / ``multiscan.fold`` spans, the
  ``multiscan.fanout.width`` gauge a chunk, and each job's finalize.  A
  spec that withdraws mid-stream is dropped from the fan-out and reported,
  and :func:`run_multi` re-runs it standalone, so the workflow's outputs
  are always complete and the same; ``STANDALONE_RERUNS`` counts every
  job run outside the scan, so a run can show that its fusion held.

The encode and the copy run on the prefetch worker and the folds on the
calling thread, both on the device's current (default) CUDA stream, so a
fold is queued after its copy.  The engine runs on a ``device`` or a
``mesh`` (default ``parallel.mesh.get_mesh()``, every visible card); on a
mesh of several positions every chunk pads to the position count and each
position folds its rows (``ChunkFold(mesh=)``).  The reference pads every
chunk to a fixed capacity, and the Markov spec's variable-length pair
streams to power-of-two buckets, so XLA compiles one shape; the port runs
eagerly and does not pad on one device, so ``FoldSpec.fixed_capacity`` is
kept (the Markov spec sets it) and ignored.

``python -m avenir_tpu_torch multi`` drives this from a properties manifest
(``multi.jobs=...`` with per-job class, conf and output keys; see
:func:`load_manifest` and ``resource/multiscan/``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .binning import ChunkedEncodeUnsupported
from .config import JobConfig, parse_properties
from .metrics import Counters
from .obs import get_tracer
from . import pipeline, telemetry

#: jobs that :func:`run_multi` ran outside the shared scan, whatever the
#: reason (no FoldSpec, a withdrawal, a failed finalize, a withdrawal
#: restored from a checkpoint), since the process started
STANDALONE_RERUNS = 0


class FoldSpec:
    """One fusable job's part of the shared scan.

    Subclasses (exported by the job modules) override :meth:`encode`
    and :meth:`finalize` and set the fold contract.  ``local_fn`` is None
    for a host-only job (exact float moments stay on the host): such a
    spec does all its work in ``encode`` and ``finalize``."""

    #: display and registry name (the manifest's job id once registered)
    name: str = "fold"
    #: one chunk's fold, ``local_fn(*arrays, mask, *static_args, out=)``
    #: -> a table or a dict of tables, added into ``out`` when given (the
    #: ``ops.counting.sharded_reduce`` contract); None for host-only specs
    local_fn: Optional[Callable] = None
    #: static arguments of the fold; may be set during the FIRST
    #: ``encode`` (the fold is built after chunk 0's encode)
    static_args: tuple = ()
    #: arrays copied to the device once and passed to every fold call
    broadcast_args: Sequence = ()
    #: the reference's choice between fixed-capacity and power-of-two
    #: padding; kept for the specs that set it, ignored by the engine
    fixed_capacity: bool = True

    def bind(self, engine: "MultiScanEngine") -> None:
        """Called at registration: the hook where a spec swaps private
        state for the engine's shared state (a shared ``DatasetEncoder``
        through :meth:`MultiScanEngine.shared_encoder`)."""

    def encode(self, ctx: "ChunkContext") -> Optional[tuple]:
        """Host work for one chunk, through the shared ``ctx`` views
        (``ctx.encoded(enc)``, ``ctx.columns(...)``, ``ctx.fields()``):
        the tuple of host arrays to fold, None to skip the chunk, or
        ``()`` from a host-only spec to mark it consumed.  Runs on the
        prefetch worker when the depth is at least 1.  Raise
        ``ChunkedEncodeUnsupported`` to withdraw from the fused pass (the
        job then runs standalone)."""
        raise NotImplementedError

    def finalize(self, carry) -> Counters:
        """Write the job's normal output file from the folded carry (host
        numpy arrays; None for host-only specs), byte for byte the
        standalone job's."""
        raise NotImplementedError


class ChunkContext:
    """One chunk's shared views, built on first use and kept, so N jobs
    cost one parse: the raw bytes; ``fields()``, the chunk split into a
    field matrix once; ``columns()``, a few typed columns by the native
    parser; ``encoded()``, the schema encode once per encoder (the native
    single-pass encode straight off the bytes)."""

    __slots__ = ("raw", "delim", "warm", "chunk_idx", "_tracer", "_memo")

    def __init__(self, raw: bytes, delim: str, tracer=None, warm=None,
                 chunk_idx: int = -1):
        self.raw = raw
        self.delim = delim
        # ``warm``: the ingest cache's adapter (core.ingestcache
        # .MultiScanCacheTee), serving this chunk's encode off a validated
        # artifact, or teeing a fresh encode toward a new one; ``chunk_idx``
        # addresses the recorded slice
        self.warm = warm
        self.chunk_idx = chunk_idx
        self._tracer = tracer or get_tracer()
        self._memo: dict = {}

    def shared(self, key, build: Callable):
        """``build()`` once per chunk for every spec asking under ``key``."""
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def fields(self):
        """The chunk's non-blank lines split into fields: a 2-D string
        array for a rectangular chunk, else per-line field lists."""
        return self.shared("fields", self._parse_fields)

    def _parse_fields(self):
        with self._tracer.span("ingest.parse", bytes=len(self.raw),
                               native=False):
            lines = [l for l in self.raw.decode().split("\n") if l]
            fields, _ = pipeline.split_field_lines(lines, self.delim)
            return fields

    def columns(self, ordinals: Tuple[int, ...],
                kinds: Optional[Tuple[int, ...]] = None):
        """Only these file columns, as typed arrays ``{ordinal: array}``
        (``kinds`` per ordinal among ``native``'s INT64, FLOAT64 and
        BYTES; BYTES by default), taken by the native parser without a
        field matrix.  None when the native path does not apply: callers
        fall back to ``fields()``."""
        key = ("columns", tuple(ordinals),
               tuple(kinds) if kinds is not None else None)
        return self.shared(
            key, lambda: self._parse_columns(tuple(ordinals), kinds))

    def _parse_columns(self, ordinals, kinds):
        from .io import is_plain_delim
        from .. import native

        if not is_plain_delim(self.delim):
            return None
        first = pipeline.first_nonblank_line(self.raw)
        if not first:
            return None
        n_cols = first.count(self.delim.encode()) + 1
        if not ordinals or max(ordinals) >= n_cols:
            return None
        col_types = [native.SKIP] * n_cols
        for i, o in enumerate(ordinals):
            col_types[o] = kinds[i] if kinds is not None else native.BYTES
        with self._tracer.span("ingest.parse", bytes=len(self.raw),
                               native=True, columns=len(ordinals)):
            res = native.parse_csv_columns_buffer(self.raw, col_types,
                                                  self.delim)
        if res is None:
            return None
        return res[1]

    def encoded(self, enc) -> tuple:
        """``(x, values, y, n)``: this chunk schema-encoded through
        ``enc``, whose vocabularies carry across chunks.  The native
        single-pass encode where it applies (raw, unshifted bucket bins:
        callers guard negative bins, as with ``encode_path_chunks``),
        else the Python encode of ``fields()``, which raises
        ``ChunkedEncodeUnsupported`` on a negative-bin column."""
        return self.shared(("encoded", id(enc)), lambda: self._encode(enc))

    def _encode(self, enc):
        if self.warm is not None and self.chunk_idx >= 0:
            res = self.warm.warm(enc, self.chunk_idx, self.raw)
            if res is not None:
                with self._tracer.span("ingest.cache.read",
                                       rows=int(res[3])):
                    return res
        res = enc.encode_buffer_chunk(self.raw, self.delim)
        if res is None:
            dsc = enc.encode(self.fields())
            if (dsc.bin_offset != 0).any():
                raise ChunkedEncodeUnsupported("negative bin")
            res = (dsc.x, dsc.values, dsc.y, dsc.n_rows)
        if self.warm is not None and self.chunk_idx >= 0:
            self.warm.tee(enc, self.chunk_idx, res)
        return res


def merge_carries(a, b):
    """The fold carry's monoid: an elementwise add over a table (tensor or
    array) or a dict, tuple or list of them.  It is the reduction a
    multi-host run performs (per-host partial folds summed), and the fold
    certificate (core.algebra) holds ``finalize(merge_carries(fold(A),
    fold(B))) == finalize(fold(A ++ B))`` for every registered spec."""
    rest = iter(pipeline.tree_leaves(b))
    return pipeline.tree_map(lambda x: x + next(rest), a)


class _SpecFailure:
    __slots__ = ("spec", "reason")

    def __init__(self, spec: FoldSpec, reason: str):
        self.spec = spec
        self.reason = reason


class MultiScanEngine:
    """Runs the shared scan and hands each chunk to every spec.

    ``h2d_copies`` and ``chunks`` count the host-to-device copies and the
    chunks of the last :meth:`run`: jobs sharing an encoder share a copy."""

    def __init__(self, mesh=None,
                 chunk_rows: int = pipeline.DEFAULT_CHUNK_ROWS,
                 prefetch_depth: int = pipeline.DEFAULT_PREFETCH_DEPTH,
                 device=None):
        from ..parallel.mesh import get_mesh, make_mesh

        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive: {chunk_rows}")
        if device is not None and mesh is not None:
            raise ValueError("pass a device or a mesh, not both")
        if device is not None:
            mesh = make_mesh([device])
        self.mesh = mesh or get_mesh()
        self.chunk_rows = int(chunk_rows)
        self.prefetch_depth = int(prefetch_depth)
        self.specs: List[FoldSpec] = []
        self.failures: List[_SpecFailure] = []
        self._encoders: Dict[object, object] = {}
        # the ingest cache's hook (ChunkContext.warm); run_multi sets it
        # when ingest.cache.enable is on
        self.warm_source = None
        self.h2d_copies = 0
        self.chunks = 0

    # -- registration ------------------------------------------------------
    def register(self, spec: FoldSpec) -> FoldSpec:
        self.specs.append(spec)
        spec.bind(self)
        return spec

    def shared_encoder(self, key, enc):
        """The one encoder for ``key`` (the first registration wins).
        Specs built from one schema file bring interchangeable fresh
        encoders; sharing one lets each chunk be encoded once for all."""
        return self._encoders.setdefault(key, enc)

    # -- the shared scan ---------------------------------------------------
    def run(self, in_path: str, delim_regex: str = ",",
            checkpointer=None, resume_carries: Optional[dict] = None,
            resume_offset: int = 0,
            resume_fed: Sequence[str] = ()) -> Dict[str, Counters]:
        """One streamed pass over ``in_path`` feeding every registered
        spec; returns ``{spec.name: Counters}`` of the specs that finished
        fused.  Withdrawn specs are in :attr:`failures`, for the caller to
        re-run standalone.

        With a ``checkpointer`` (core.checkpoint), every ``interval``
        chunks the producer pickles the registered specs and the
        withdrawals, and the consumer saves them with every fold's carry
        (a snapshot queued after the chunk's fold, copied to the host one
        chunk later) and the chunk-end byte offset.  To resume, the caller
        registers the restored spec objects (their mid-stream host state
        rides the pickle) and passes the saved carries, offset and fed
        set; chunk boundaries derive from the whole buffer, so the resumed
        scan folds the same remaining chunks."""
        tracer = get_tracer()
        parent = tracer.current_span_id()
        trace = tracer.current_trace_id()
        xfer = pipeline.ChunkTransfer(mesh=self.mesh, tracer=tracer)
        folds: Dict[FoldSpec, pipeline.ChunkFold] = {}
        # `active` changes only on the encode side (the worker when the
        # depth is >= 1); the fold side sees a withdrawal as a spec that
        # stops appearing in the chunk items
        active: List[FoldSpec] = list(self.specs)
        fed_any: set = {s for s in self.specs if s.name in set(resume_fed)}
        produced: set = {s.name for s in fed_any}
        # no cache on a resumed scan: its chunk indices restart mid-file,
        # so warm slices would misalign and a tee'd artifact be partial
        cache_tee = self.warm_source if resume_offset == 0 else None
        n_chunks_seen = [0]
        self.h2d_copies = 0
        self.chunks = 0

        def make_fold(spec: FoldSpec) -> pipeline.ChunkFold:
            broadcast = tuple(
                torch.from_numpy(np.ascontiguousarray(b)).to(xfer.device)
                for b in spec.broadcast_args)
            return pipeline.ChunkFold(
                spec.local_fn, static_args=spec.static_args,
                mesh=self.mesh, tracer=tracer, parent=parent,
                broadcast=broadcast, span_name="multiscan.fold",
                span_attrs={"job": spec.name})

        # resumed carries are seeded now: a spec may see no further chunk
        # (a kill near the end) and must still finalize from its carry
        for spec in self.specs:
            carry = (resume_carries or {}).get(spec.name)
            if carry is not None and spec.local_fn is not None:
                cf = make_fold(spec)
                cf.seed(carry)
                folds[spec] = cf

        def transfer(arrs):
            self.h2d_copies += 1
            return xfer(arrs)

        def encode_chunk(item) -> tuple:
            """((spec, device tuple | None) pairs, checkpoint token) of one
            raw byte chunk: the parse, encode and copy, on the prefetch
            worker."""
            raw, chunk_idx, end_offset = item
            n_chunks_seen[0] = max(n_chunks_seen[0], chunk_idx + 1)
            self.chunks += 1
            ctx = ChunkContext(raw, delim_regex, tracer,
                               warm=cache_tee, chunk_idx=chunk_idx)
            items: list = []
            for spec in list(active):
                try:
                    with tracer.span("multiscan.encode", job=spec.name):
                        arrs = spec.encode(ctx)
                    if arrs is None:
                        continue
                    if spec.local_fn is None:
                        items.append((spec, None))
                        continue
                    # the memo keeps the host arrays beside the device
                    # tuple: an id()-based key is unambiguous only while
                    # every keyed array lives for the chunk
                    arrs = tuple(arrs)
                    _, dev = ctx.shared(
                        ("h2d", tuple(id(a) for a in arrs)),
                        lambda: (arrs, transfer(arrs)))
                except Exception as exc:  # noqa: BLE001 — withdrawal, not
                    # abort: any encode or transfer failure of one spec
                    # (a cap overflow, an unparseable value, an unknown
                    # symbol) withdraws that job only; the others keep the
                    # shared scan, and the standalone re-run reproduces
                    # the job's own success or error
                    active.remove(spec)
                    reason = (str(exc) if isinstance(
                        exc, ChunkedEncodeUnsupported)
                        else f"{type(exc).__name__}: {exc}")
                    self.failures.append(_SpecFailure(spec, reason))
                    continue
                items.append((spec, dev))
                produced.add(spec.name)
            token = None
            if checkpointer is not None and checkpointer.due(chunk_idx):
                # pickled here, on the producer: every spec's host state
                # as of this chunk, consistent with the carries the
                # consumer snapshots after folding it
                token = checkpointer.token(chunk_idx, end_offset, {
                    "specs": {s.name: s for s in active},
                    "failures": [(f.spec.name, f.reason)
                                 for f in self.failures],
                    "fed": sorted(produced)})
            return items, token

        def fold_items(items: list) -> None:
            tracer.gauge("multiscan.fanout.width", len(items))
            for spec, dev in items:
                fed_any.add(spec)
                if dev is None:
                    continue
                cf = folds.get(spec)
                if cf is None:
                    # made at the spec's first fold, after its first
                    # encode set static_args from chunk 0
                    cf = folds[spec] = make_fold(spec)
                cf.fold(dev)
            # one residency sample a chunk (rate limited): N jobs' carries
            # and the shared chunk, what device.hbm.bytes should see
            telemetry.sample_device_memory()

        serial = self.prefetch_depth <= 0
        # the async checkpoint: every fold's snapshot is taken at the
        # token's consume and copied to the host one consume later
        saver = (pipeline.AsyncCheckpointSaver(
            checkpointer, tracer,
            lambda snaps: {name: pipeline.ChunkFold.host_copy(snap)
                           for name, snap in snaps.items()})
            if checkpointer is not None else None)

        def consume(pair) -> None:
            items, token = pair
            fold_items(items)
            if serial:
                for cf in folds.values():
                    cf.block()
            if saver is not None:
                saver.flush()
                if token is not None:
                    saver.push(token, {spec.name: cf.snapshot()
                                       for spec, cf in folds.items()})

        chunks = pipeline.iter_byte_chunks_meta(in_path, self.chunk_rows,
                                                start_offset=resume_offset)
        pipeline.drive_prefetched(chunks, encode_chunk, consume,
                                  self.prefetch_depth, tracer=tracer,
                                  parent=parent, trace=trace,
                                  thread_name="avenir-multiscan-prefetch")
        if saver is not None:
            saver.flush()
        if cache_tee is not None:
            # publish only the builders the scan fed gap-free to the end
            cache_tee.finish(n_chunks_seen[0])

        # -- finalize every remaining spec --------------------------------
        results: Dict[str, Counters] = {}
        for spec in list(active):
            carry = folds[spec].result() if spec in folds else None
            if spec.local_fn is not None and carry is None:
                # a device spec that folded no chunk (an empty stream, or
                # every chunk skipped): no fused result, run standalone
                active.remove(spec)
                self.failures.append(_SpecFailure(spec, "empty stream"))
                continue
            if spec.local_fn is None and spec not in fed_any:
                active.remove(spec)
                self.failures.append(_SpecFailure(spec, "empty stream"))
                continue
            try:
                with tracer.span("multiscan.finalize", job=spec.name):
                    results[spec.name] = spec.finalize(carry)
            except Exception as exc:  # noqa: BLE001 — one job's emit
                # failure (an unwritable output path) must not cost the
                # other jobs their outputs; the standalone re-run
                # reproduces and raises this job's own error
                active.remove(spec)
                self.failures.append(_SpecFailure(
                    spec, f"finalize failed: {type(exc).__name__}: {exc}"))
        return results


# ---------------------------------------------------------------------------
# the properties-file manifest (the `multi` command)
# ---------------------------------------------------------------------------

#: streaming-fold consumers that do not export a FoldSpec, with the reason
NON_FUSABLE: Dict[str, str] = {
    "DecisionTreeBuilder":
        "iterative multi-level growth: each level's fold is keyed by the "
        "previous level's routing decisions, so one shared scan cannot "
        "feed all levels",
    "FrequentItemsApriori":
        "k-pass pipeline: pass k's candidate itemsets derive from pass "
        "k-1's output file, so the passes cannot share one scan",
}


class JobEntry:
    """One manifest job: the job object, its FoldSpec (if fusable under its
    config) and its output path."""

    __slots__ = ("jid", "cls_name", "job", "spec", "out_path")

    def __init__(self, jid, cls_name, job, spec, out_path):
        self.jid = jid
        self.cls_name = cls_name
        self.job = job
        self.spec = spec
        self.out_path = out_path


def load_manifest(config: JobConfig, out_base: Optional[str],
                  resolver: Callable) -> List[JobEntry]:
    """Build each job of a ``multi.*`` manifest.

    Keys::

        multi.jobs=nb,mi,corr                # required: job ids, in order
        multi.job.<id>.class=<JobClass>      # required: short or FQCN
        multi.job.<id>.conf.path=<props>     # optional per-job file
        multi.job.<id>.output.path=<dir>     # optional (default
                                             #   <out_base>/<id>)
        multi.job.<id>.<key>=<value>         # inline per-job overrides

    A job's config is the manifest's keys outside ``multi.*``, overlaid by
    its conf file, overlaid by its inline keys, under the job's prefix
    (``resolver`` returns the registry's ``(factory, prefix)``).  Every
    job must read the shared ``field.delim.regex`` (one scan, one parse).
    """
    ids = [s.strip() for s in config.must("multi.jobs").split(",")
           if s.strip()]
    if not ids:
        raise SystemExit("multi.jobs is empty")
    if len(set(ids)) != len(ids):
        raise SystemExit(f"duplicate job ids in multi.jobs: {ids}")
    shared_delim = config.field_delim_regex()
    base_props = {k: v for k, v in config.props.items()
                  if not k.startswith("multi.")}
    entries: List[JobEntry] = []
    for jid in ids:
        cls_name = config.must(f"multi.job.{jid}.class")
        props = dict(base_props)
        conf_path = config.get(f"multi.job.{jid}.conf.path")
        if conf_path:
            with open(conf_path, "r") as fh:
                props.update(parse_properties(fh.read()))
        reserved = ("class", "conf.path", "output.path")
        for k, v in config.subkeys(f"multi.job.{jid}").items():
            if k not in reserved:
                props[k] = v
        factory, prefix = resolver(cls_name)
        job_cfg = JobConfig(props, prefix)
        if job_cfg.field_delim_regex() != shared_delim:
            raise SystemExit(
                f"multi job {jid!r}: field.delim.regex "
                f"{job_cfg.field_delim_regex()!r} differs from the shared "
                f"scan's {shared_delim!r} (one scan = one parse)")
        out_path = config.get(f"multi.job.{jid}.output.path")
        if out_path is None:
            if out_base is None:
                raise SystemExit(
                    f"multi job {jid!r}: no multi.job.{jid}.output.path "
                    f"and no <out> CLI argument to derive it from")
            out_path = os.path.join(out_base, jid)
        job = factory(job_cfg)
        spec_fn = getattr(job, "fold_spec", None)
        spec = spec_fn(out_path) if spec_fn is not None else None
        entries.append(JobEntry(jid, cls_name, job, spec, out_path))
    return entries


def run_standalone(job, in_path: str, out_path: str, mesh=None):
    """``job.run`` on its own scan: on the job's device for no mesh or a
    mesh of one position, else with ``mesh=`` (every job's ``run`` takes
    one, as the reference's standalone re-run passes it)."""
    if mesh is None or mesh.size == 1:
        return job.run(in_path, out_path)
    return job.run(in_path, out_path, mesh=mesh)


def run_multi(config: JobConfig, in_path: str, out_base: Optional[str],
              resolver: Callable, mesh=None,
              log=None) -> Dict[str, Counters]:
    """Run a ``multi.*`` manifest: one fused scan for every fusable job,
    then standalone runs of the rest (no FoldSpec, a config the spec
    cannot serve, a mid-stream withdrawal), so the workflow's outputs are
    complete and equal those of running each job separately.  ``mesh``
    defaults to ``get_mesh()``; the jobs the ``resolver`` builds must run
    on its first device."""
    from .checkpoint import StreamCheckpointer
    from .ingestcache import multiscan_cache_tee

    tracer = get_tracer()
    entries = load_manifest(config, out_base, resolver)
    engine = MultiScanEngine(
        mesh=mesh,
        chunk_rows=config.pipeline_chunk_rows(
            default=pipeline.DEFAULT_CHUNK_ROWS),
        prefetch_depth=config.pipeline_prefetch_depth())
    mesh = engine.mesh
    # with the ingest cache on, schema-encoding specs read their chunks
    # off a validated artifact for this (input, encoder, delimiter,
    # chunk_rows), and a miss tees the fresh encodes into a new artifact
    engine.warm_source = multiscan_cache_tee(
        config, in_path, engine.chunk_rows, config.field_delim_regex())

    fused_ids = [e.jid for e in entries if e.spec is not None]
    ck = StreamCheckpointer.from_config(
        config, kind="multiscan", in_path=in_path,
        default_path=(os.path.join(out_base, "_multiscan.ckpt")
                      if out_base else in_path + ".multiscan.ckpt"),
        params={"chunk_rows": engine.chunk_rows,
                "jobs": ",".join(fused_ids),
                "delim": config.field_delim_regex()})
    resume_carries: Dict[str, object] = {}
    resume_offset = 0
    resume_fed: List[str] = []
    restored_failures: Dict[str, str] = {}
    if ck is not None and ck.resume:
        payload = ck.load()
        if payload is not None:
            state = payload["state"]
            # the restored specs carry their mid-stream host state
            # (vocabularies, caps, host buffers); specs pickled in one
            # dump share their encoders, so shared_encoder dedupes them
            # the same way on re-registration
            for e in entries:
                if e.spec is not None and e.jid in state["specs"]:
                    e.spec = state["specs"][e.jid]
            restored_failures = dict(state["failures"])
            resume_fed = list(state["fed"])
            resume_carries = payload["carry"] or {}
            resume_offset = payload["offset"]
            if log is not None:
                log(f"multiscan: resuming from {ck.path} at chunk "
                    f"{payload['chunk_index']} (byte offset "
                    f"{resume_offset})")

    fused: Dict[str, JobEntry] = {}
    standalone: List[Tuple[JobEntry, str]] = []
    for e in entries:
        if e.spec is None:
            standalone.append((e, "no FoldSpec under this class/config"))
            continue
        if e.jid in restored_failures:
            # withdrawn before the kill: the resumed run goes straight to
            # the standalone re-run
            standalone.append(
                (e, restored_failures[e.jid] + " (from checkpoint)"))
            continue
        e.spec.name = e.jid
        engine.register(e.spec)
        fused[e.jid] = e

    # the scan roots a fresh trace unless one is active
    scan_ctx = None
    if tracer.enabled and tracer.current_trace_id() is None:
        from .obs import new_trace_context
        scan_ctx = new_trace_context(sampled=True)
    results: Dict[str, Counters] = {}
    with tracer.span("multiscan.scan", jobs=",".join(fused),
                     ctx=scan_ctx,
                     span_id=scan_ctx.span_id if scan_ctx else None):
        results.update(engine.run(
            in_path, config.field_delim_regex(), checkpointer=ck,
            resume_carries=resume_carries, resume_offset=resume_offset,
            resume_fed=resume_fed))
    for failure in engine.failures:
        standalone.append((fused[failure.spec.name], failure.reason))

    global STANDALONE_RERUNS
    first_error = None
    for e, reason in standalone:
        STANDALONE_RERUNS += 1
        if log is not None:
            log(f"multiscan: job {e.jid!r} ({e.cls_name}) running "
                f"standalone: {reason}")
        try:
            with tracer.span("multiscan.standalone", job=e.jid):
                results[e.jid] = run_standalone(e.job, in_path, e.out_path,
                                                mesh)
        except Exception as exc:  # noqa: BLE001 — finish the other jobs
            # first, then raise this job's own error: one bad job must not
            # cost the rest of the workflow their outputs
            if log is not None:
                log(f"multiscan: job {e.jid!r} failed standalone: "
                    f"{type(exc).__name__}: {exc}")
            if first_error is None:
                first_error = exc
    if first_error is not None:
        # the sidecar (if any) stays: a failed workflow is resumable
        raise first_error
    if ck is not None:
        ck.complete()
    return results
