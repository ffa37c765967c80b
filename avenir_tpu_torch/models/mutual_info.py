"""Mutual information distributions and feature-selection scores.

The port's counterpart of ``avenir_tpu/models/mutual_info.py``, with the
same config keys and output bytes.  ``MutualInformation`` folds two count
tables on the job's device: ``FC[class, feature, bin]`` through
``ops.counting.feature_class_counts`` (kernel K1 on the card) and
``PC[pair, b1, b2, class]`` over every i < j feature pair through
``count_table``; on a mesh both are summed by ``sharded_reduce(mesh=)``.
The seven distribution families, the four MI sections and the ranked
scores (``MutualInformationScore``: MIM, MIFS, JMI, DISR, mRMR) are
computed on the host from those tables with ``math.log``, as the
reference does, so every output byte is the reference's.

With ``pipeline.chunk.rows`` the input streams in row chunks through
``core.pipeline.streaming_fold`` (one K1 launch a chunk), and with
``ingest.cache.enable`` through the parse-once cache
(``core.ingestcache``); a chunk the streamed path cannot take (a late
class, a bin beyond the cap, a negative bin) makes the job re-run the
one-shot encode, so the bytes never depend on the path.  With a mesh
the streamed path shards every chunk's rows over the mesh's positions
and sums both tables with its ``psum`` (``streaming_fold(mesh=)``).
``check_pair_table_budget`` refuses a schema whose pair table would
exceed ``pipeline.device.budget.bytes`` before any input is read.

``fold_spec`` exports the job's part of a shared scan (core.multiscan):
``_MIFoldSpec`` shares the schema encode and the copy with co-registered
jobs on the same schema file, and folds both tables, a dict carry.
``parse_scores`` reads a written ranking back (the DAG's artifact
import).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.binning import DatasetEncoder, EncodedDataset
from ..core.config import JobConfig
from ..core.io import write_output
from ..core.metrics import Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..core.obs import get_tracer, traced_run
from ..core.schema import FeatureSchema
from ..device import resolve_device
from ..ops.counting import count_table, feature_class_counts, sharded_reduce


def _mi_local(x, y, mask, n_class, max_bins, pair_i, pair_j, out=None):
    """Both tables of one row block: ``fc`` by K1 (``x`` goes to it
    untouched) and ``pc`` by one ``count_table`` over the gathered pair
    columns.  With ``out`` (a streamed fold's carry) they are added into
    its tables in place."""
    fc = feature_class_counts(x, y, n_class, max_bins, mask=mask,
                              out=None if out is None else out["fc"])
    pi = torch.as_tensor(pair_i, dtype=torch.int64, device=x.device)
    pj = torch.as_tensor(pair_j, dtype=torch.int64, device=x.device)
    p_idx = torch.arange(len(pair_i), device=x.device)[None, :]
    m = None if mask is None else mask[:, None]
    pc = count_table((len(pair_i), max_bins, max_bins, n_class),
                     (p_idx, x[:, pi], x[:, pj], y[:, None]), mask=m)
    if out is None:
        return {"fc": fc, "pc": pc}
    out["pc"] += pc
    return out


class MutualInformationScore:
    """Feature-ranking algorithms (MutualInformationScore.java)."""

    def __init__(self):
        self.feature_mi: List[Tuple[int, float]] = []
        self.pair_mi: List[Tuple[int, int, float]] = []
        self.pair_class_mi: List[Tuple[int, int, float]] = []
        self.pair_class_entropy: List[Tuple[int, int, float]] = []

    # -- MIM ----------------------------------------------------------------
    def mim(self) -> List[Tuple[int, float]]:
        return sorted(self.feature_mi, key=lambda t: -t[1])

    # -- MIFS ---------------------------------------------------------------
    def mifs(self, redundancy_factor: float) -> List[Tuple[int, float]]:
        out, selected = [], set()
        while len(selected) < len(self.feature_mi):
            best, best_f = -math.inf, 0
            for f, mi in self.feature_mi:
                if f in selected:
                    continue
                red = sum(v for a, b, v in self.pair_mi
                          if (a == f and b in selected)
                          or (b == f and a in selected))
                score = mi - redundancy_factor * red
                if score > best:
                    best, best_f = score, f
            out.append((best_f, best))
            selected.add(best_f)
        return out

    # -- JMI / DISR ---------------------------------------------------------
    def _jmi_helper(self, joint: bool) -> List[Tuple[int, float]]:
        out, selected = [], set()
        first = self.mim()[0]
        out.append(first)
        selected.add(first[0])
        while len(selected) < len(self.feature_mi):
            best, best_f = -math.inf, 0
            for f, _ in self.feature_mi:
                if f in selected:
                    continue
                s = 0.0
                for a, b, v in self.pair_class_mi:
                    if (a == f and b in selected) or (b == f and a in selected):
                        if joint:
                            s += v
                        else:
                            ent = self._pair_entropy(a, b)
                            s += v / ent
                if s > best:
                    best, best_f = s, f
            out.append((best_f, best))
            selected.add(best_f)
        return out

    def jmi(self) -> List[Tuple[int, float]]:
        return self._jmi_helper(True)

    def disr(self) -> List[Tuple[int, float]]:
        return self._jmi_helper(False)

    def _pair_entropy(self, a: int, b: int) -> float:
        for x, y, v in self.pair_class_entropy:
            if (x == a and y == b) or (x == b and y == a):
                return v
        raise KeyError((a, b))

    # -- mRMR ---------------------------------------------------------------
    def mrmr(self) -> List[Tuple[int, float]]:
        out, selected = [], set()
        while len(selected) < len(self.feature_mi):
            best, best_f = -math.inf, 0
            for f, mi in self.feature_mi:
                if f in selected:
                    continue
                red = sum(v for a, b, v in self.pair_mi
                          if (a == f and b in selected)
                          or (b == f and a in selected))
                score = (mi - red / len(selected)) if selected else mi
                if score > best:
                    best, best_f = score, f
            out.append((best_f, best))
            selected.add(best_f)
        return out


_ALGOS = {
    "mutual.info.maximization": lambda s, rf: s.mim(),
    "mutual.info.selection": lambda s, rf: s.mifs(rf),
    "joint.mutual.info": lambda s, rf: s.jmi(),
    "double.input.symmetric.relevance": lambda s, rf: s.disr(),
    "min.redundancy.max.relevance": lambda s, rf: s.mrmr(),
}


class _MIStreamState:
    """Per-chunk guards, cap sizing, and bin/row accounting of the
    streamed MI path."""

    def __init__(self, enc: DatasetEncoder):
        self.enc = enc
        ffields = enc.feature_fields
        self.F = len(ffields)
        self.num_bins_seen = np.zeros(self.F, dtype=np.int64)
        self.n_rows = 0
        self.caps: Dict[str, int] = {}
        self.declared = [f.num_bins() if (f.is_bucket_width_defined()
                                          and f.max is not None) else 0
                         for f in ffields]
        self.pair_i: Tuple[int, ...] = ()
        self.pair_j: Tuple[int, ...] = ()

    def size_caps(self) -> None:
        """Bin/class extents from the declared schema + the first
        accepted chunk (+headroom); call after the first ``accept``."""
        cat_card = [len(self.enc.vocabs[f.ordinal])
                    for f in self.enc.feature_fields if f.is_categorical()]
        self.caps["B"] = int(max([1] + self.declared + cat_card
                                 + list(self.num_bins_seen))) + 4
        self.caps["C"] = max(len(self.enc.class_vocab), 1) + 2
        self.pair_i, self.pair_j = map(tuple, np.triu_indices(self.F, k=1))

    def accept(self, x, y, n: int):
        """Guard one encoded chunk; returns the (x, y) fold arrays or
        None for an empty chunk.  ``x`` carries raw (unshifted) bins —
        callers on the shifting Python encode guard ``bin_offset``
        themselves; the negative check here covers the native path."""
        from ..core.binning import ChunkedEncodeUnsupported

        if n == 0:
            return None
        if (x < 0).any():
            raise ChunkedEncodeUnsupported("negative bin")
        mx = x.max(axis=0) + 1
        np.maximum(self.num_bins_seen, mx, out=self.num_bins_seen)
        if self.caps and (int(mx.max()) > self.caps["B"]
                          or int(y.max()) >= self.caps["C"]):
            raise ChunkedEncodeUnsupported("cap overflow")
        self.n_rows += n
        return x, y


def pair_table_bytes(F: int, B: int, C: int) -> int:
    """Estimated device bytes of the MI count tables: the dominant
    ``PC[pair, b1, b2, class]`` int32 over all i<j feature pairs plus
    the ``FC[class, feature, bin]`` table — the quadratic-in-features,
    quadratic-in-bins residency this job materializes per device."""
    n_pairs = F * (F - 1) // 2
    return 4 * (n_pairs * B * B * C + C * F * B)


def check_pair_table_budget(cfg, F: int, B: int, C: int) -> None:
    """Fail fast — BEFORE any device allocation — when the estimated MI
    pair-table residency exceeds the configured
    ``pipeline.device.budget.bytes``.  The PC table grows as
    F^2/2 * B^2 * C int32 cells, so a wide or finely-binned schema turns
    into an opaque device OOM mid-fold; this guard turns it into an
    actionable error naming the estimate and the knobs (no guard when no
    budget is declared)."""
    from ..core import pipeline

    budget = cfg.get_int(pipeline.KEY_DEVICE_BUDGET, None)
    if budget is None:
        return
    est = pair_table_bytes(F, B, C)
    if est > budget:
        n_pairs = F * (F - 1) // 2
        raise ValueError(
            f"MutualInformation pair tables need ~{est} bytes per device "
            f"({n_pairs} feature pairs x {B}x{B} bins x {C} classes, "
            f"int32) which exceeds {pipeline.KEY_DEVICE_BUDGET}={budget}. "
            f"Raise the budget, coarsen bucketWidth (fewer bins), or "
            f"reduce the feature set (e.g. a prior feature-select stage).")


class MutualInformation:
    """The MI job."""

    def __init__(self, config: JobConfig,
                 schema: Optional[FeatureSchema] = None, device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)
        for f in self.schema.feature_fields():
            if not f.is_categorical() and not f.is_bucket_width_defined():
                raise ValueError(
                    f"MutualInformation requires bucketWidth on numeric "
                    f"feature {f.name!r} (reference has no unbinned path)")
        # the ceiling from the declared extents alone, before any input is
        # read (discovered extents are checked again at cap sizing)
        ffields = self.schema.feature_fields()
        decl_bins = [f.num_bins() for f in ffields
                     if f.is_categorical() or f.max is not None]
        cls = self.schema.class_attr_field()
        check_pair_table_budget(
            config, len(ffields), max(decl_bins, default=1),
            max(len(cls.cardinality), 1))

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        enc = DatasetEncoder(self.schema)
        tracer = get_tracer()
        chunk_rows = cfg.pipeline_chunk_rows(
            row_bytes=4 * (len(enc.feature_fields) + 1))
        if chunk_rows is not None:
            with tracer.span("phase:train"):
                res = self._run_streamed(
                    enc, in_path, out_path, cfg, delim, counters, mesh,
                    chunk_rows, cfg.pipeline_prefetch_depth())
            if res is not None:
                return res
            enc = DatasetEncoder(self.schema)   # fresh vocabs for fallback
            counters = Counters()
        with tracer.span("phase:train"):
            ds = enc.encode_path(in_path, cfg.field_delim_regex())
            counters.set("Basic", "Records", ds.n_rows)
            F = ds.n_features
            C = len(ds.class_vocab)
            B = max(ds.num_bins)
            check_pair_table_budget(cfg, F, B, C)
            pair_i, pair_j = map(tuple, np.triu_indices(F, k=1))
            kw = {"mesh": mesh} if mesh is not None else {"device": self.device}
            res = sharded_reduce(_mi_local, ds.x, ds.y,
                                 static_args=(C, B, pair_i, pair_j), **kw)
            fc = res["fc"].cpu().numpy().astype(np.int64)     # [C, F, B]
            pc = res["pc"].cpu().numpy().astype(np.int64)     # [P, B, B, C]
        with tracer.span("phase:emit"):
            lines = self._emit(ds, fc, pc, pair_i, pair_j, delim, cfg)
            write_output(out_path, lines)
        return counters

    def _run_streamed(self, enc: DatasetEncoder, in_path, out_path, cfg,
                      delim, counters: Counters, mesh, chunk_rows: int,
                      depth: int) -> Optional[Counters]:
        """Chunked streaming MI: row chunks parse and encode on the
        prefetch worker (vocabularies grow in input order, as in the
        one-shot encode) and both tables fold on the device through
        ``core.pipeline``.  Bin and class extents are capped from the
        declared schema and the first chunk (with headroom); an overflow
        (a late class value, a bin beyond the cap, or a negative-bin
        column, whose shift is global) returns None and the caller re-runs
        the monolithic path, so the output is the same.

        With the ingest cache on, a validated artifact for this input,
        schema, delimiter and ``chunk_rows`` replays its mmapped encoded
        chunks (MI's all-binned ``x`` is the artifact's raw-bin matrix);
        a miss tees this scan into a new artifact.  The per-chunk guards
        run on the warm replay too, so a cap overflow falls back alike."""
        from ..core import ingestcache, pipeline
        from ..core.binning import ChunkedEncodeUnsupported

        delim_regex = cfg.field_delim_regex()
        st = _MIStreamState(enc)
        cache = ingestcache.IngestCache.from_config(cfg, in_path, enc,
                                                    delim_regex)
        builder = None
        scan = cache.load(chunk_rows) if cache is not None else None
        if scan is not None:
            scan.seed_encoder(enc)

            def encoded():
                for x, values, y, n, _ in scan.chunks():
                    out = st.accept(np.asarray(x), np.asarray(y), n)
                    if out is not None:
                        yield out
        else:
            if cache is not None:
                builder = cache.builder(chunk_rows)

            def encoded():
                for arr in pipeline.iter_field_chunks(in_path, delim_regex,
                                                      chunk_rows):
                    dsc = enc.encode(arr)
                    if (dsc.bin_offset != 0).any():
                        raise ChunkedEncodeUnsupported("negative bin")
                    out = st.accept(dsc.x, dsc.y, dsc.n_rows)
                    if out is not None:
                        if builder is not None:
                            builder.add(dsc.x, dsc.values, dsc.y,
                                        dsc.n_rows)
                        yield out

        try:
            first, stream = pipeline.peek(encoded())
            if first is None:
                if builder is not None:
                    builder.abort()
                return None
            st.size_caps()
            check_pair_table_budget(cfg, st.F, st.caps["B"], st.caps["C"])
            res = pipeline.streaming_fold(
                stream, _mi_local,
                static_args=(st.caps["C"], st.caps["B"],
                             st.pair_i, st.pair_j),
                device=self.device, mesh=mesh, prefetch_depth=depth)
        except ChunkedEncodeUnsupported:
            if builder is not None:
                builder.abort()
            return None
        if res is None:
            if builder is not None:
                builder.abort()
            return None
        if builder is not None:
            builder.finish()
        counters.set("Basic", "Records", st.n_rows)
        with get_tracer().span("phase:emit"):
            write_output(out_path,
                         self._streamed_lines(enc, st, res, delim, cfg))
        return counters

    def _streamed_lines(self, enc: DatasetEncoder, st: _MIStreamState,
                        res, delim, cfg) -> List[str]:
        """Output lines from a streamed fold result."""
        ffields = enc.feature_fields
        F = len(ffields)
        num_bins = []
        for j, f in enumerate(ffields):
            if f.is_categorical():
                num_bins.append(len(enc.vocabs[f.ordinal]))
            else:
                num_bins.append(max(st.declared[j], int(st.num_bins_seen[j])))
        C = len(enc.class_vocab)
        B = max(num_bins)
        fc = np.asarray(res["fc"], dtype=np.int64)[:C, :, :B]
        pc = np.asarray(res["pc"], dtype=np.int64)[:, :B, :B, :C]
        ds_meta = EncodedDataset(
            schema=enc.schema, feature_fields=ffields,
            x=np.zeros((0, F), np.int32), values=np.zeros((0, F)),
            y=np.zeros(0, np.int32), num_bins=num_bins,
            bin_offset=np.zeros(F, np.int32),
            binned_mask=np.ones(F, dtype=bool),
            vocabs=enc.vocabs, class_vocab=enc.class_vocab)
        return self._emit(ds_meta, fc, pc, st.pair_i, st.pair_j, delim, cfg)

    def fold_spec(self, out_path: str):
        """This job's shared-scan ``core.multiscan.FoldSpec``."""
        return _MIFoldSpec(self, out_path)

    @staticmethod
    def parse_scores(lines, algorithm: Optional[str] = None,
                     delim: str = ",") -> List[Tuple[int, float]]:
        """The ranked ``(ordinal, score)`` list out of this job's output
        lines: the artifact import of the workflow's feature-select stage
        (core.dag).  ``algorithm`` picks one
        ``mutualInformationScoreAlgorithm:`` section (default: the
        first); an unknown one raises KeyError naming what the artifact
        holds.  A line in a score section that is not ``ordinal,score``
        raises ValueError naming it."""
        sections: Dict[str, List[Tuple[int, float]]] = {}
        current: Optional[str] = None
        for line in lines:
            if line.startswith("mutualInformationScoreAlgorithm:"):
                current = line.split(":", 1)[1].strip()
                sections[current] = []
                continue
            if current is None:
                continue
            if ":" in line and delim not in line:
                current = None          # a following non-score header
                continue
            parts = line.split(delim)
            if len(parts) == 2:
                try:
                    parsed = (int(parts[0]), float(parts[1]))
                except ValueError:
                    # score sections end the artifact, so anything else
                    # here is a partial write or a hand edit
                    raise ValueError(
                        f"malformed score line in MI artifact section "
                        f"{current!r}: {line!r}") from None
                sections[current].append(parsed)
        if not sections:
            raise ValueError(
                "no mutualInformationScoreAlgorithm section in the MI "
                "artifact (was the job run with "
                "mutual.info.score.algorithms set?)")
        if algorithm is None:
            return next(iter(sections.values()))
        if algorithm not in sections:
            raise KeyError(
                f"MI artifact has no score section {algorithm!r}; "
                f"present: {sorted(sections)}")
        return sections[algorithm]

    # -- host post-processing ----------------------------------------------
    def _emit(self, ds: EncodedDataset, fc, pc, pair_i, pair_j, delim,
              cfg) -> List[str]:
        out: List[str] = []
        F = ds.n_features
        C, B = fc.shape[0], fc.shape[2]
        ords = [f.ordinal for f in ds.feature_fields]
        class_vals = ds.class_vocab.values
        class_counts = fc[:, 0, :].sum(axis=1)           # every row binned
        total = int(class_counts.sum())
        feat = fc.sum(axis=0)                            # [F, B]
        pair = pc.sum(axis=3)                            # [P, B, B]

        def bl(j, b):
            return ds.bin_label(j, b)

        # ---- distributions ----
        out.append("distribution:class")
        for c in range(C):
            out.append(f"{class_vals[c]}{delim}{class_counts[c] / total}")

        out.append("distribution:feature")
        for j in range(F):
            for b in range(B):
                if feat[j, b]:
                    out.append(f"{ords[j]}{delim}{bl(j, b)}{delim}"
                               f"{feat[j, b] / total}")

        out.append("distribution:featurePair")
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            for b1 in range(B):
                for b2 in range(B):
                    v = pair[p, b1, b2]
                    if v:
                        out.append(
                            f"{ords[i]}{delim}{ords[j]}{delim}{bl(i, b1)}"
                            f"{delim}{bl(j, b2)}{delim}{v / total}")

        out.append("distribution:featureClass")
        for j in range(F):
            for b in range(B):
                for c in range(C):
                    v = fc[c, j, b]
                    if v:
                        out.append(f"{ords[j]}{delim}{bl(j, b)}{delim}"
                                   f"{class_vals[c]}{delim}{v / total}")

        out.append("distribution:featurePairClass")
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            for b1 in range(B):
                for b2 in range(B):
                    for c in range(C):
                        v = pc[p, b1, b2, c]
                        if v:
                            out.append(
                                f"{ords[i]}{delim}{ords[j]}{delim}{bl(i, b1)}"
                                f"{delim}{bl(j, b2)}{delim}{class_vals[c]}"
                                f"{delim}{v / total}")

        out.append("distribution:featureClassConditional")
        for j in range(F):
            for c in range(C):
                for b in range(B):
                    v = fc[c, j, b]
                    if v:
                        out.append(f"{ords[j]}{delim}{class_vals[c]}{delim}"
                                   f"{bl(j, b)}{delim}{v / class_counts[c]}")

        out.append("distribution:featurePairClassConditional")
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            for c in range(C):
                for b1 in range(B):
                    for b2 in range(B):
                        v = pc[p, b1, b2, c]
                        if v:
                            out.append(
                                f"{ords[i]}{delim}{ords[j]}{delim}"
                                f"{class_vals[c]}{delim}{bl(i, b1)}{delim}"
                                f"{bl(j, b2)}{delim}{v / class_counts[c]}")

        # ---- mutual information ----
        score = MutualInformationScore()

        out.append("mutualInformation:feature")
        for j in range(F):
            s = 0.0
            for b in range(B):
                if not feat[j, b]:
                    continue
                fp = feat[j, b] / total
                for c in range(C):
                    v = fc[c, j, b]
                    if v:
                        jp = v / total
                        s += jp * math.log(jp / (fp * class_counts[c] / total))
            out.append(f"{ords[j]}{delim}{s}")
            score.feature_mi.append((ords[j], s))

        out.append("mutualInformation:featurePair")
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            s = 0.0
            for b1 in range(B):
                if not feat[i, b1]:
                    continue
                p1 = feat[i, b1] / total
                for b2 in range(B):
                    if not feat[j, b2]:
                        continue
                    p2 = feat[j, b2] / total
                    v = pair[p, b1, b2]
                    if v:
                        jp = v / total
                        s += jp * math.log(jp / (p1 * p2))
            out.append(f"{ords[i]}{delim}{ords[j]}{delim}{s}")
            score.pair_mi.append((ords[i], ords[j], s))

        out.append("mutualInformation:featurePairClass")
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            s = 0.0
            ent = 0.0
            for b1 in range(B):
                for b2 in range(B):
                    jf = pair[p, b1, b2]
                    if not jf:
                        continue
                    jfp = jf / total
                    for c in range(C):
                        v = pc[p, b1, b2, c]
                        if v:
                            jp = v / total
                            s += jp * math.log(
                                jp / (jfp * class_counts[c] / total))
                            ent -= jp * math.log(jp)
            out.append(f"{ords[i]}{delim}{ords[j]}{delim}{s}")
            score.pair_class_mi.append((ords[i], ords[j], s))
            score.pair_class_entropy.append((ords[i], ords[j], ent))

        out.append("mutualInformation:featurePairClassConditional")
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            total_s = 0.0
            for c in range(C):
                cp = class_counts[c] / total
                s = 0.0
                for b1 in range(B):
                    v1 = fc[c, i, b1]
                    if not v1:
                        continue
                    # reference normalizes class-conditional marginals by
                    # TOTAL count here (MutualInformation.java:759-762)
                    p1 = v1 / total
                    for b2 in range(B):
                        v2 = fc[c, j, b2]
                        if not v2:
                            continue
                        p2 = v2 / total
                        v = pc[p, b1, b2, c]
                        if v:
                            jp = v / total
                            s += cp * (jp * math.log(jp / (p1 * p2)))
                total_s += s
            out.append(f"{ords[i]}{delim}{ords[j]}{delim}{total_s}")

        # ---- scores ----
        algos = cfg.get("mutual.info.score.algorithms",
                        "mutual.info.maximization").split(",")
        rf = cfg.get_float("mutual.info.redundancy.factor", 1.0)
        for alg in algos:
            out.append(f"mutualInformationScoreAlgorithm: {alg}")
            fn = _ALGOS.get(alg)
            if fn is None:
                continue
            for f, v in fn(score, rf):
                out.append(f"{f}{delim}{v}")
        return out


class _MIFoldSpec(MultiScanFoldSpec):
    """MutualInformation's part of the shared scan: shares the schema
    encode (and the copy) with co-registered jobs on the same schema file,
    folds both distribution tables on the device (K1 and the pair count,
    a dict carry) and writes the job's normal output file.  The fold
    certificate (core.algebra) holds its split invariance."""

    def __init__(self, job: "MutualInformation", out_path: str):
        self.job = job
        self.out_path = out_path
        self.name = type(job).__name__
        self.local_fn = _mi_local
        self.static_args: tuple = ()
        self.enc = DatasetEncoder(job.schema)
        self.delim = job.config.field_delim_out()
        self.st: Optional[_MIStreamState] = None

    def bind(self, engine) -> None:
        import os
        sp = self.job.config.get("feature.schema.file.path")
        if sp:
            self.enc = engine.shared_encoder(
                ("schema-encoder", os.path.abspath(sp)), self.enc)

    def encode(self, ctx):
        x, _, y, n = ctx.encoded(self.enc)
        if self.st is None:
            self.st = _MIStreamState(self.enc)
        out = self.st.accept(x, y, n)
        if out is not None and not self.st.caps:
            self.st.size_caps()
            check_pair_table_budget(self.job.config, self.st.F,
                                    self.st.caps["B"], self.st.caps["C"])
            self.static_args = (self.st.caps["C"], self.st.caps["B"],
                                self.st.pair_i, self.st.pair_j)
        return out

    def finalize(self, carry) -> Counters:
        counters = Counters()
        counters.set("Basic", "Records", self.st.n_rows)
        lines = self.job._streamed_lines(self.enc, self.st, carry,
                                         self.delim, self.job.config)
        write_output(self.out_path, lines)
        return counters
