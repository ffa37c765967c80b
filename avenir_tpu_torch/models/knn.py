"""k-nearest-neighbor pipeline on one CUDA card: the distance job, the
probability joiner and the voting classifier.

The port's counterpart of ``avenir_tpu/models/knn.py``, with the same
config keys, input layouts and output bytes:

- ``SameTypeSimilarity`` (the sifarish distance job of resource/knn.sh)
  emits ``trainId, testId, distance, [trainClass, testClass]`` pair lines
  with int distances scaled by ``distance.scale``; with
  ``output.top.matches`` only the k nearest training rows per test row,
  selected on the card by kernel K3 (ops.topk) when the reference's gates
  allow, else by the sorted engine (ops.distance);
- ``FeatureCondProbJoiner`` joins the pair lines with the Naive Bayes
  ``output.feature.prob.only`` lines for class-conditional weighting;
- ``NearestNeighbor`` votes over the top-K neighbors per test row with
  ``Neighborhood``'s kernels and weights, in the reference's Java integer
  arithmetic (numpy on the host).

Parity notes carried over from the reference: the non-weighted
class-distribution output keeps its field separator, and the ``sigmoid``
kernel raises instead of leaving every neighborhood unscored.

Every job takes a ``device``; the distance job computes on it (or on the
mesh passed to its ``run``), and jobs with no device work still resolve
it, so that no entry point quietly runs on the CPU.  The serving adapter
is ``serve.engine.NearestNeighborAdapter``.

The distance job reads each set's part files as bytes and parses them
by column with ``native.parse_csv_columns_buffer``: float64 numeric
feature columns (the values ``float()`` gives), fixed-width bytes for
the id, the class and categorical columns, whose codes it gives in
first-seen order over the training rows, then the test rows.  Where
that parser cannot take the input, or might read text that ``float()``
refuses (a delimiter that is not one plain character, text that is not
ASCII or holds a carriage return, a NUL, ``0x`` or ``(``, a ragged row,
an unparseable number, a set with no rows, an input held in an artifact
store) the job splits every line in Python instead; both readers give
the same output bytes.

The distance job's pair lines, where the columnar reader took the input
and ``field.delim.out`` is ASCII with no NUL, are built as bytes from
the engine's ``(dist, idx)`` arrays and the reader's byte columns
(``_write_pair_columns``): the pairs chosen with array operations (a
self-join's diagonal masked, each row's first ``output.top.matches``
kept), the fields gathered into one fixed-width byte matrix a block of
test rows at a time, the distances written as decimal digits, the
padding dropped with one mask, each block written through a binary
``OutputWriter``; ``COLUMNAR_EMITS`` counts those jobs.  The Python
reader's sets, and any other delimiter, take the per-line emit
(``_pair_lines``); both give the same bytes.

The vote job, for a plain majority vote (classification without
class-conditional weighting, class distribution, decision threshold or
cost-based arbitration), reads the pair lines' bytes and parses the test
id, the distance and the classes by column with the same parser, then
decides every neighbourhood at once with array operations
(``NearestNeighbor._vote_columns``), each decision the one
``classify_group`` gives; ``COLUMNAR_VOTES`` counts those jobs.  Other
settings, and input that parser cannot take or might read otherwise
than ``int()`` (as above, and a distance wider than 18 bytes or a sign
followed by blanks), take the per-group path: each line split and
grouped by its test id, each group decided by ``classify_group``, as
the serving adapter decides its few.

Spans (``core.obs``): the distance job records ``ingest.read``,
``ingest.parse``, ``knn.distance`` (the ``pairwise_distances`` call:
the operands' upload, K3, K3m and the copy back) and ``knn.emit`` (the
pair lines, built and written; ``columnar`` says which emit the job
took); the vote job ``ingest.read`` (the part
files' bytes, or their lines on the per-group path), ``ingest.parse``
(the column parse, or each line split and grouped; ``columnar`` says
which reader the job took) and ``knn.vote`` (the decisions, the
confusion counts and the prediction lines).
"""

from __future__ import annotations

import math
import os
import threading
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from ..core.config import JobConfig
from ..core.io import (_input_files, read_lines, split_line, write_output,
                       write_output_blocks)
from ..core.metrics import ConfusionMatrix, CostBasedArbitrator, Counters
from ..core.obs import get_tracer, traced_run
from ..core.schema import FeatureSchema
from ..device import resolve_device
from ..ops.distance import pairwise_distances

KERNEL_SCALE = 100
PROB_SCALE = 100


# ---------------------------------------------------------------------------
# distance job (sifarish SameTypeSimilarity equivalent)
# ---------------------------------------------------------------------------

class SameTypeSimilarity:
    """Pairwise entity distances between a training and a test set (or a
    self-join), schema-driven.

    Config surface (resource/knn.properties:9-17): ``distance.scale``,
    ``inter.set.matching``, ``base.set.split.prefix`` (file-name prefix
    marking training-set files), plus ours: ``distance.algorithm``
    (euclidean|manhattan), ``include.class.attributes``,
    ``output.top.matches`` (emit only the k nearest per test entity via
    device top-k instead of all pairs)."""

    def __init__(self, config: JobConfig, schema: Optional[FeatureSchema] = None,
                 device=None):
        self.config = config
        self.schema = schema or FeatureSchema.from_file(
            config.must("feature.schema.file.path"))
        self.device = resolve_device(device)

    def _assemble(self, n: int, numeric, categorical):
        """The feature matrices of ``n`` rows from a column source:
        ``numeric(field)`` gives a float64 column, ``categorical(field)``
        its int32 codes.  Numeric columns are range-normalized to [0,1]
        when min/max are declared.  Returns ``(num, cat, num_weights,
        cat_weights)``."""
        num_cols, cat_cols = [], []
        num_w, cat_w = [], []
        for f in self.schema.feature_fields():
            w = float(f.extra.get("weight", 1.0))
            if f.is_categorical():
                cat_cols.append(categorical(f))
                cat_w.append(w)
            else:
                col = numeric(f)
                if f.min is not None and f.max is not None and f.max > f.min:
                    col = (col - f.min) / (f.max - f.min)
                num_cols.append(col)
                num_w.append(w)
        num = (np.stack(num_cols, axis=1) if num_cols
               else np.zeros((n, 0)))
        cat = (np.stack(cat_cols, axis=1) if cat_cols
               else np.zeros((n, 0), dtype=np.int32))
        return num, cat, np.asarray(num_w), np.asarray(cat_w)

    def _encode(self, records: List[List[str]],
                vocabs: Dict[int, Dict[str, int]]):
        """Split records encoded (``_assemble``): categorical columns to
        vocab codes.  ``vocabs`` is SHARED between the train and test
        encode calls so undeclared values get one consistent code across
        both sets."""
        def categorical(f):
            vocab = vocabs.setdefault(
                f.ordinal, {v: i for i, v in enumerate(f.cardinality or [])})
            return np.asarray([vocab.setdefault(r[f.ordinal], len(vocab))
                               for r in records], dtype=np.int32)

        return self._assemble(
            len(records),
            lambda f: np.asarray([float(r[f.ordinal]) for r in records]),
            categorical)

    def _read_records(self, in_path: str, delim_regex: str, prefix: str,
                      inter_set: bool, include_class: bool, cls_field):
        """The Python reader: every line split, then ``_encode``.
        Returns ``_Sets``."""
        tracer = get_tracer()
        with tracer.span("ingest.read", path=in_path):
            files = [(os.path.basename(fp).startswith(prefix),
                      list(read_lines(fp))) for fp in _input_files(in_path)]
        with tracer.span("ingest.parse", native=False):
            train_recs: List[List[str]] = []
            test_recs: List[List[str]] = []
            for is_base, lines in files:
                for line in lines:
                    rec = split_line(line, delim_regex)
                    (train_recs if is_base or not inter_set else test_recs
                     ).append(rec)
            del files
            if not inter_set:
                test_recs = train_recs
            vocabs: Dict[int, Dict[str, int]] = {}
            tnum, tcat, num_w, cat_w = self._encode(train_recs, vocabs)
            qnum, qcat, _, _ = self._encode(test_recs, vocabs)
            id_ord = self.schema.id_field().ordinal
            cls_ord = (cls_field.ordinal if include_class
                       and cls_field is not None else None)

            def strings(recs, o):
                return None if o is None else [r[o] for r in recs]
            return _Sets(tnum, tcat, qnum, qcat, num_w, cat_w,
                         strings(train_recs, id_ord),
                         strings(test_recs, id_ord),
                         strings(train_recs, cls_ord),
                         strings(test_recs, cls_ord))

    def _read_columns(self, in_path: str, delim_regex: str, prefix: str,
                      inter_set: bool, include_class: bool, cls_field):
        """The columnar reader: each set's part files joined and parsed
        by ``native.parse_csv_columns_buffer`` (FLOAT64 numeric feature
        columns, BYTES for the id, the class and categorical columns),
        categorical codes given in first-seen order over the training
        rows, then the test rows, as ``_encode`` gives them.  Returns
        ``_Sets``, or None where the Python reader must run: a delimiter
        that is not one plain character, a set with no rows, an input
        held in an artifact store, text that is not ASCII or holds a
        carriage return, a NUL byte, ``0x`` or ``(``, a column the schema
        reads as both a number and text, or what the native parser
        refuses (a ragged row, an unparseable number)."""
        from .. import native
        from ..core.io import get_artifact_store, is_plain_delim

        files = _input_files(in_path)
        id_field = self.schema.id_field()
        store = get_artifact_store()
        if (not is_plain_delim(delim_regex) or id_field is None
                or (store is not None
                    and any(store.peek(fp) is not None for fp in files))):
            return None
        tracer = get_tracer()
        with tracer.span("ingest.read", path=in_path):
            parts: Tuple[List[bytes], List[bytes]] = ([], [])
            for fp in files:
                is_base = os.path.basename(fp).startswith(prefix)
                with open(fp, "rb") as fh:
                    parts[0 if is_base or not inter_set else 1].append(
                        fh.read())
        bufs = [b"\n".join(p) for p in parts[:2 if inter_set else 1]]
        with tracer.span("ingest.parse", native=True,
                         bytes=sum(len(b) for b in bufs)):
            want = {id_field.ordinal: native.BYTES}
            if include_class and cls_field is not None:
                want[cls_field.ordinal] = native.BYTES
            for f in self.schema.feature_fields():
                kind = native.BYTES if f.is_categorical() else native.FLOAT64
                if want.setdefault(f.ordinal, kind) != kind:
                    return None
            sets = []
            for buf in bufs:
                cols = _parse_columns(buf, delim_regex, want)
                if cols is None:
                    return None
                sets.append(cols)
            if not inter_set:
                sets.append(sets[0])
            (n_tr, tr), (n_te, te) = sets
            codes = {}
            for f in self.schema.feature_fields():
                if f.is_categorical():
                    codes[f.ordinal] = _first_seen_codes(
                        {v: i for i, v in enumerate(f.cardinality or [])},
                        tr[f.ordinal], te[f.ordinal])
            tnum, tcat, num_w, cat_w = self._assemble(
                n_tr, lambda f: tr[f.ordinal],
                lambda f: codes[f.ordinal][0])
            qnum, qcat, _, _ = self._assemble(
                n_te, lambda f: te[f.ordinal],
                lambda f: codes[f.ordinal][1])
            cls_ord = (cls_field.ordinal if include_class
                       and cls_field is not None else None)
            return _Sets(tnum, tcat, qnum, qcat, num_w, cat_w,
                         tr[id_field.ordinal], te[id_field.ordinal],
                         None if cls_ord is None else tr[cls_ord],
                         None if cls_ord is None else te[cls_ord])

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        """The distance job; with ``mesh`` (``parallel.mesh.Mesh``) the
        distances run on that mesh instead of the job's device, with the
        same output bytes."""
        counters = Counters()
        tracer = get_tracer()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        inter_set = self.config.get_boolean("inter.set.matching", True)
        prefix = self.config.get("base.set.split.prefix", "tr")
        scale = self.config.get_int("distance.scale", 1000)
        algorithm = self.config.get("distance.algorithm", "euclidean")
        include_class = self.config.get_boolean("include.class.attributes",
                                                True)
        top_k = self.config.get_int("output.top.matches", None)
        # 'exact' (default) reproduces the secondary-sort ordering and
        # auto-selects the fused engine K3 on a CUDA device; the two exact
        # engines may differ by +/-1 int unit where a distance lands on
        # the int-scale rounding boundary (ops.distance.pairwise_distances);
        # 'fused'/'sorted' force one engine, 'approx' is answered exactly;
        # validated here so a typo fails loudly even on dense-output runs
        # where no selection runs
        topk_method = self.config.get("topk.method", "exact")
        if topk_method not in ("exact", "fused", "sorted", "approx"):
            raise ValueError(f"unknown top-k method {topk_method!r}; "
                             "use 'exact', 'fused', 'sorted' or 'approx'")

        cls_field = None
        try:
            cls_field = self.schema.class_attr_field()
        except ValueError:
            include_class = False
        read = (self._read_columns(in_path, delim_regex, prefix, inter_set,
                                   include_class, cls_field)
                or self._read_records(in_path, delim_regex, prefix,
                                      inter_set, include_class, cls_field))
        n_train, n_test = len(read.train_ids), len(read.test_ids)
        counters.set("Basic", "Training records", n_train)
        counters.set("Basic", "Test records", n_test)

        # self-join: request one extra neighbor so the zero-distance
        # diagonal entry does not consume a top-k slot
        effective_k = (top_k + 1 if top_k and not inter_set else top_k)
        stats: dict = {}
        with tracer.span("knn.distance", queries=n_test, candidates=n_train):
            dist, idx = pairwise_distances(
                read.qnum, read.qcat, read.tnum, read.tcat, read.num_w,
                read.cat_w, algorithm=algorithm, scale=scale,
                top_k=effective_k,
                device=None if mesh is not None else self.device,
                topk_method=topk_method, stats=stats, mesh=mesh)
        counters.set("Distance", "Fused engine calls",
                     int(stats["engine"] == "fused"))
        counters.set("Distance", "Re-resolved rows", stats["reresolved"])

        # the columnar emit takes the columnar reader's byte columns and a
        # delimiter that stays one byte a character and holds no NUL
        columnar = (isinstance(read.train_ids, np.ndarray)
                    and delim.isascii() and "\0" not in delim)
        with tracer.span("knn.emit", queries=n_test, columnar=columnar):
            if columnar:
                pairs = _write_pair_columns(out_path, read, dist, idx, top_k,
                                            inter_set, delim.encode())
                _count("COLUMNAR_EMITS")
            else:
                lines = _pair_lines(_text_sets(read), dist, idx, top_k,
                                    inter_set, delim)
                pairs = len(lines)
                write_output(out_path, lines)
            counters.set("Basic", "Pairs emitted", pairs)
        return counters


class _Sets(NamedTuple):
    """What the distance job's readers give: both sets' feature matrices
    (``_assemble``), the weights, and each row's id and class (the class
    None where the pair lines carry none): lists of text from the Python
    reader, fixed-width bytes arrays from the columnar one."""
    tnum: np.ndarray
    tcat: np.ndarray
    qnum: np.ndarray
    qcat: np.ndarray
    num_w: np.ndarray
    cat_w: np.ndarray
    train_ids: Union[List[str], np.ndarray]
    test_ids: Union[List[str], np.ndarray]
    train_cls: Union[List[str], np.ndarray, None]
    test_cls: Union[List[str], np.ndarray, None]


def _text_sets(read: _Sets) -> _Sets:
    """``read`` with byte columns turned into lists of text, as the
    per-line emit takes them."""
    def text(col):
        return (col.astype(str).tolist() if isinstance(col, np.ndarray)
                else col)
    return read._replace(train_ids=text(read.train_ids),
                         test_ids=text(read.test_ids),
                         train_cls=text(read.train_cls),
                         test_cls=text(read.test_cls))


def _pair_lines(read: _Sets, dist: np.ndarray, idx: Optional[np.ndarray],
                top_k: Optional[int], inter_set: bool,
                delim: str) -> List[str]:
    """The per-line emit (the Python reader's sets, or an output
    delimiter the columnar emit does not take): each test row's
    candidates (``idx``'s row, or every training row where ``idx`` is
    None) in rank order, a self-join skipping the row itself, the first
    ``top_k`` kept; a line ``trainId, testId, distance, [trainClass,
    testClass]`` each."""
    n_train = len(read.train_ids)
    with_class = read.train_cls is not None
    # Python ints, row by row: no numpy scalar a pair
    idx_rows = idx.tolist() if idx is not None else None
    lines: List[str] = []
    for qi in range(len(read.test_ids)):
        drow = dist[qi].tolist()
        cols = idx_rows[qi] if idx_rows is not None else range(n_train)
        emitted = 0
        for rank, ti in enumerate(cols):
            if not inter_set and ti == qi:
                continue   # self-join skips the diagonal
            if top_k and emitted == top_k:
                break
            d = drow[rank] if idx_rows is not None else drow[ti]
            parts = [read.train_ids[ti], read.test_ids[qi], str(d)]
            if with_class:
                parts.append(read.train_cls[ti])
                parts.append(read.test_cls[qi])
            lines.append(delim.join(parts))
            emitted += 1
    return lines


#: candidate entries (query rows times candidates a row) of one block of
#: the columnar emit: its working set is about 30 bytes an entry
_EMIT_BLOCK_PAIRS = 1 << 21


def _write_pair_columns(out_path: str, read: _Sets, dist: np.ndarray,
                        idx: Optional[np.ndarray], top_k: Optional[int],
                        inter_set: bool, delim: bytes) -> int:
    """The columnar emit: ``_pair_lines``'s lines, byte for byte, built
    as bytes from the engine's arrays and the columnar reader's byte
    columns a block of query rows at a time (``_selected_pairs``,
    ``_decimal``, ``_line_bytes``) and written by
    ``write_output_blocks``.  Returns the count of lines."""
    n_train, n_test = len(read.train_ids), len(read.test_ids)
    step = max(_EMIT_BLOCK_PAIRS
               // max(n_train if idx is None else idx.shape[1], 1), 1)
    train_id, test_id = _byte_matrix(read.train_ids), _byte_matrix(
        read.test_ids)
    with_class = read.train_cls is not None
    if with_class:
        train_cls, test_cls = (_byte_matrix(read.train_cls),
                               _byte_matrix(read.test_cls))
    emitted = 0

    def blocks():
        nonlocal emitted
        for lo in range(0, n_test, step):
            q, rank, t = _selected_pairs(idx, n_train, lo,
                                         min(lo + step, n_test), top_k,
                                         inter_set)
            emitted += len(q)
            fields = [np.take(train_id, t, axis=0),
                      np.take(test_id, q, axis=0), _decimal(dist[q, rank])]
            if with_class:
                fields += [np.take(train_cls, t, axis=0),
                           np.take(test_cls, q, axis=0)]
            yield _line_bytes(fields, delim)
    write_output_blocks(out_path, blocks())
    return emitted


def _selected_pairs(idx: Optional[np.ndarray], n_train: int, lo: int,
                    hi: int, top_k: Optional[int], inter_set: bool
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pairs ``_pair_lines`` writes for test rows ``lo:hi``, in its
    order (row by row, rank by rank), as ``(test row, rank, training
    row)`` arrays: a self-join masks each row's own index, and ``top_k``
    keeps a row's first ``top_k`` entries left."""
    cand = (idx[lo:hi] if idx is not None
            else np.broadcast_to(np.arange(n_train), (hi - lo, n_train)))
    keep = (np.ones(cand.shape, bool) if inter_set
            else cand != np.arange(lo, hi)[:, None])
    if top_k:
        keep &= np.cumsum(keep, axis=1) <= top_k
    q, rank = np.nonzero(keep)
    return q + lo, rank, cand[q, rank]


def _byte_matrix(col: np.ndarray) -> np.ndarray:
    """A fixed-width bytes column as a ``[n, width]`` uint8 matrix, NUL
    after each value that is shorter than the width."""
    return (np.ascontiguousarray(col).view(np.uint8)
            .reshape(len(col), col.dtype.itemsize))


def _decimal(values: np.ndarray) -> np.ndarray:
    """Integers (int32 or narrower) as decimal text in a ``[n, width]``
    uint8 matrix: each row, its NULs dropped, is ``str(int(value))`` (a
    sign column first, then the digits right-aligned, NUL in every place
    that holds neither)."""
    v = values.astype(np.int64)
    rest = np.abs(v)
    width = len(str(int(rest.max()))) if len(v) else 1
    text = np.zeros((len(v), width + 1), np.uint8)
    text[:, 0] = np.where(v < 0, ord("-"), 0)
    for j in range(width, 0, -1):
        digit = rest % 10 + ord("0")
        text[:, j] = digit if j == width else np.where(rest > 0, digit, 0)
        rest //= 10
    return text


def _line_bytes(fields: List[np.ndarray], delim: bytes) -> bytes:
    """Lines of ``fields`` (each a ``[n, width]`` uint8 matrix, NUL where
    a value is shorter than the width) joined by ``delim`` and each ended
    by a newline, as one bytes object: laid out in one matrix whose NULs
    go with one mask, as the text holds none (``_parse_columns``)."""
    sep = np.frombuffer(delim, np.uint8)
    width = (sum(f.shape[1] for f in fields)
             + len(sep) * (len(fields) - 1) + 1)
    out = np.empty((len(fields[0]), width), np.uint8)
    at = 0
    for i, f in enumerate(fields):
        if i:
            out[:, at:at + len(sep)] = sep
            at += len(sep)
        out[:, at:at + f.shape[1]] = f
        at += f.shape[1]
    out[:, at] = ord("\n")
    flat = out.reshape(-1)
    return flat[flat != 0].tobytes()


def _parse_columns(buf: bytes, delim: str, want: Dict[int, int],
                   widths: Optional[List[int]] = None):
    """``(n_rows, {ordinal: array})`` of the file columns ``want`` names
    (``native`` column kinds) from one set's bytes, or None where the
    Python reader must run instead (see ``_read_columns``); ``widths``
    as ``native.parse_csv_columns_buffer`` fills it."""
    from .. import native
    from ..core.pipeline import first_nonblank_line

    # strtod also takes hexadecimal and "nan(...)" text, which float()
    # refuses: such input goes to the Python reader, which raises
    if (not buf.isascii() or b"\r" in buf or b"\0" in buf or b"0x" in buf
            or b"0X" in buf or b"(" in buf):
        return None
    first = first_nonblank_line(buf)
    if not first:
        return None
    n_cols = first.count(delim.encode()) + 1
    if max(want) >= n_cols:
        return None
    col_types = [native.SKIP] * n_cols
    for o, kind in want.items():
        col_types[o] = kind
    return native.parse_csv_columns_buffer(buf, col_types, delim, widths)


def _first_seen_codes(vocab: Dict[str, int], train: np.ndarray,
                      test: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int32 codes of a categorical column's training and test values
    (fixed-width bytes): ``vocab`` (the declared values) extended by each
    new value in first-seen order, training rows first, as
    ``SameTypeSimilarity._encode``'s shared vocabulary gives them."""
    both = np.concatenate([train, test])
    uniq, first, inverse = np.unique(both, return_index=True,
                                     return_inverse=True)
    code = np.empty(len(uniq), np.int64)
    for u in np.argsort(first, kind="stable"):
        code[u] = vocab.setdefault(uniq[u].decode(), len(vocab))
    codes = code[inverse.reshape(-1)].astype(np.int32)
    return codes[:len(train)], codes[len(train):]


# ---------------------------------------------------------------------------
# FeatureCondProbJoiner
# ---------------------------------------------------------------------------

class FeatureCondProbJoiner:
    """Joins distance pairs with NB feature-posterior lines
    (knn/FeatureCondProbJoiner.java).

    Prob lines are the BayesianPredictor's ``output.feature.prob.only``
    format: ``id, featPrior, class1, post1, class2, post2, actualClass``
    (BayesianPredictor.java output path); the joiner keeps, per training
    item, the posterior of its OWN class value
    (FeatureCondProbJoiner.java reducer first-tuple scan).  Output:
    ``testId, testClass, trainId, distance, trainClass, postProb`` — the
    exact column order NearestNeighbor's class-condition-weighted mapper
    expects (NearestNeighbor.java:137-149)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        # ``mesh`` is taken, as every job's run takes one, and not used:
        # this job runs on the host, as the reference's does
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        prefix = self.config.get("feature.cond.prob.split.prefix", "condProb")

        prob: Dict[str, Tuple[str, str]] = {}
        pair_lines: List[List[str]] = []
        for root in in_path.split(","):
            for fp in _input_files(root):
                is_prob = os.path.basename(fp).startswith(prefix)
                for line in read_lines(fp):
                    items = split_line(line, delim_regex)
                    if is_prob:
                        # id, featPrior, (class, post)*, actualClass
                        actual = items[-1]
                        post = ""
                        for i in range(2, len(items) - 1, 2):
                            if items[i] == actual:
                                post = items[i + 1]
                                break
                        prob[items[0]] = (actual, post)
                    else:
                        pair_lines.append(items)

        out: List[str] = []
        for items in pair_lines:
            train_id, test_id, dist = items[0], items[1], items[2]
            test_class = items[4] if len(items) > 4 else ""
            cls, post = prob.get(train_id, ("", ""))
            out.append(delim.join(
                [test_id, test_class, train_id, dist, cls, post]))
            counters.incr("Join", "Joined pairs")
        write_output(out_path, out)
        return counters


# ---------------------------------------------------------------------------
# Neighborhood (voting / kernel library)
# ---------------------------------------------------------------------------

class Neighborhood:
    """Vectorized Neighborhood (knn/Neighborhood.java): kernel scores for a
    whole [n_test, k] neighbor block at once; per-neighborhood reductions
    follow the reference's integer arithmetic."""

    CLASSIFICATION = "classification"
    REGRESSION = "regression"

    def __init__(self, kernel_function: str = "none", kernel_param: int = -1,
                 class_cond_weighted: bool = False,
                 inverse_distance_weighted: bool = False):
        self.kernel_function = kernel_function
        self.kernel_param = kernel_param
        self.class_cond_weighted = class_cond_weighted
        self.inverse_distance_weighted = inverse_distance_weighted

    def scores(self, distances: np.ndarray) -> np.ndarray:
        """Integer kernel score per neighbor (Neighborhood.java:126-160)."""
        d = distances.astype(np.int64)
        if self.kernel_function == "none":
            return np.ones_like(d)
        if self.kernel_function == "linearMultiplicative":
            return np.where(d == 0, 2 * KERNEL_SCALE,
                            KERNEL_SCALE // np.maximum(d, 1))
        if self.kernel_function == "linearAdditive":
            return KERNEL_SCALE - d
        if self.kernel_function == "gaussian":
            t = d.astype(np.float64) / self.kernel_param
            return (KERNEL_SCALE * np.exp(-0.5 * t * t)).astype(np.int64)
        raise ValueError(
            f"unsupported kernel function {self.kernel_function}")

    def weighted_scores(self, scores: np.ndarray, distances: np.ndarray,
                        post_probs: np.ndarray) -> np.ndarray:
        """Class-conditional weighting (Neighborhood.Neighbor.setScore,
        Neighborhood.java:52-66 of the inner class): score * postProb,
        optionally * 1/distance."""
        w = np.where(post_probs > 0, scores * post_probs,
                     scores.astype(np.float64))
        if self.inverse_distance_weighted:
            w = w / np.maximum(distances, 1e-12)
        return w


# ---------------------------------------------------------------------------
# NearestNeighbor classifier/regressor job
# ---------------------------------------------------------------------------

class NearestNeighbor:
    """Top-K voting job (knn/NearestNeighbor.java)."""

    def __init__(self, config: JobConfig, schema: Optional[FeatureSchema] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        c = config
        self.top_match_count = c.get_int("top.match.count", 10)
        self.validation = c.get_boolean("validation.mode", True)
        # the reference reads BOTH spellings: the mapper uses
        # "class.condition.weighted" (NearestNeighbor.java:121), the reducer
        # "class.condtion.weighted" (:239, matching knn.properties:37)
        ccw = c.get("class.condition.weighted", c.get("class.condtion.weighted"))
        self.class_cond_weighted = str(ccw).lower() == "true"
        self.prediction_mode = c.get("prediction.mode", "classification")
        self.regression_method = c.get("regression.method", "average")
        self.neighborhood = Neighborhood(
            c.get("kernel.function", "none"), c.get_int("kernel.param", -1),
            self.class_cond_weighted,
            c.get_boolean("inverse.distance.weighted", False))
        self.output_class_distr = c.get_boolean("output.class.distr", False)
        self.decision_threshold = c.get_float("decision.threshold", -1.0)
        self.use_cost_based = c.get_boolean("use.cost.based.classifier", False)
        self.pos_class = self.neg_class = None
        self.arbitrator = None
        if (self.decision_threshold > 0 or self.use_cost_based) \
                and self.prediction_mode == "classification":
            vals = c.must("class.attribute.values").split(",")
            self.pos_class, self.neg_class = vals[0], vals[1]
            if self.use_cost_based:
                cost = [int(v) for v in
                        c.must("misclassification.cost").split(",")]
                self.arbitrator = CostBasedArbitrator(
                    self.neg_class, self.pos_class, cost[1], cost[0])
        self.conf_matrix = None
        if self.validation and self.prediction_mode == "classification":
            schema = schema or FeatureSchema.from_file(
                c.must("feature.schema.file.path"))
            card = schema.class_attr_field().cardinality
            self.conf_matrix = ConfusionMatrix(card[0], card[1])

    # -- per-neighborhood decisions (Neighborhood.java:224-320) ----------
    @staticmethod
    def _distribution(class_vals: List[str],
                      scores: np.ndarray) -> Dict[str, float]:
        distr: Dict[str, float] = defaultdict(float)
        for cv, s in zip(class_vals, scores):
            distr[cv] += s
        return distr

    def _classify(self, distr: Dict[str, float]) -> str:
        if self.decision_threshold > 0 and not self.class_cond_weighted:
            pos = distr.get(self.pos_class, 0)
            neg = max((v for k, v in distr.items() if k != self.pos_class),
                      default=0)
            # neg == 0 -> pos/neg = Infinity in the reference
            # (Neighborhood.java:300), i.e. unanimous positive wins
            ratio = pos / neg if neg > 0 else float("inf")
            return (self.pos_class if ratio > self.decision_threshold
                    else self.neg_class)
        best, best_score = None, 0
        for cv, s in distr.items():
            if s > best_score:
                best, best_score = cv, s
        return best if best is not None else ""

    def _class_prob(self, distr: Dict[str, float], class_val: str) -> int:
        total = sum(distr.values())
        if total <= 0:
            return 0
        return int(distr.get(class_val, 0) * PROB_SCALE / total)

    def _regress(self, class_vals: List[str], regr_in: List[float],
                 test_regr_in: float) -> int:
        vals = [int(float(v)) for v in class_vals]
        if self.regression_method == "average":
            return int(sum(vals) / len(vals))   # int division parity
        if self.regression_method == "median":
            vals.sort()
            mid = len(vals) // 2
            return (vals[mid] if len(vals) % 2 == 1
                    else (vals[mid - 1] + vals[mid]) // 2)
        if self.regression_method == "linearRegression":
            x = np.asarray(regr_in, dtype=np.float64)
            yv = np.asarray([float(v) for v in class_vals])
            xm, ym = x.mean(), yv.mean()
            sxx = ((x - xm) ** 2).sum()
            slope = ((x - xm) * (yv - ym)).sum() / sxx if sxx > 0 else 0.0
            return int(ym + slope * (test_regr_in - xm))
        raise ValueError(
            f"unsupported regression method {self.regression_method}")

    def classify_group(self, neighbors: List[Tuple], test_id: str,
                       test_class_val: str = "",
                       test_regr_val: float = 0.0) -> Tuple[str, str]:
        """One neighborhood decision: ``neighbors`` are (dist, trainId,
        trainClass, postProb, regrIn) tuples in arrival order.  Returns
        (output line, predicted): the per-reducer-group body of ``run``."""
        delim = self.config.field_delim_out()
        ccw = self.class_cond_weighted
        neighbors = sorted(neighbors, key=lambda t: t[0])
        top = neighbors[:self.top_match_count]
        dists = np.asarray([t[0] for t in top])
        cvals = [t[2] for t in top]
        posts = np.asarray([t[3] for t in top])
        scores = self.neighborhood.scores(dists)
        if ccw:
            scores = self.neighborhood.weighted_scores(scores, dists, posts)

        distr = self._distribution(cvals, scores)
        parts = [test_id]
        if self.output_class_distr \
                and self.prediction_mode == "classification":
            for cv, s in distr.items():
                parts += [cv, str(s if ccw else int(s))]
        if self.validation:
            parts.append(test_class_val)

        if self.prediction_mode == "classification":
            if self.use_cost_based:
                pos_prob = self._class_prob(distr, self.pos_class)
                predicted = self.arbitrator.classify(pos_prob)
            else:
                predicted = self._classify(distr)
        else:
            predicted = str(self._regress(
                cvals, [t[4] for t in top], test_regr_val))
        parts.append(predicted)
        return delim.join(parts), predicted

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        # ``mesh`` is taken, as every job's run takes one, and not used:
        # this job runs on the host, as the reference's does
        counters = Counters()
        delim_regex = self.config.field_delim_regex()

        # mapper parse (NearestNeighbor.java:130-180): by column where the
        # settings and the input allow, else each line split and grouped
        # by its test id in one pass, so no split line outlives it
        tracer = get_tracer()
        with tracer.span("ingest.read", path=in_path):
            buf = self._read_bytes(in_path, delim_regex)
            lines = list(read_lines(in_path)) if buf is None else None
        with tracer.span("ingest.parse", columnar=False) as span:
            cols = (None if buf is None
                    else self._parse_pairs(buf, delim_regex))
            del buf
            if cols is None:
                if lines is None:
                    lines = list(read_lines(in_path))
                rows = len(lines)
                groups, test_class, test_regr = self._map(lines, delim_regex)
            else:
                rows = len(cols[1])
            if hasattr(span, "attrs"):        # the tracer is on
                span.attrs.update(columnar=cols is not None, rows=rows)
        del lines
        if cols is not None:
            with tracer.span("knn.vote"):
                self._vote_columns(cols, out_path, counters)
            _count("COLUMNAR_VOTES")
            return counters
        with tracer.span("knn.vote", groups=len(groups)):
            self._vote(groups, test_class, test_regr, out_path, counters)
        return counters

    def _read_bytes(self, in_path: str, delim_regex: str) -> Optional[bytes]:
        """The input's part files joined by newlines, or None where the
        vote cannot run by column: settings other than a plain majority
        vote (regression, class-conditional weighting, a class
        distribution in the output, a decision threshold, the cost-based
        arbitrator, ``top.match.count`` under 1), a delimiter that is not
        one plain character, or an input held in an artifact store."""
        from ..core.io import get_artifact_store, is_plain_delim

        store = get_artifact_store()
        if (self.prediction_mode != "classification"
                or self.class_cond_weighted or self.output_class_distr
                or self.decision_threshold > 0 or self.use_cost_based
                or self.top_match_count < 1
                or not is_plain_delim(delim_regex)
                or (store is not None and store.peek(in_path) is not None)):
            return None
        parts = []
        for fp in _input_files(in_path):
            with open(fp, "rb") as fh:
                parts.append(fh.read())
        return b"\n".join(parts)

    def _parse_pairs(self, buf: bytes, delim: str):
        """The pair lines' test id, distance, training class and (in
        validation mode) test class by column (``_parse_columns``), or
        None where the mapper must split the lines: what
        ``_parse_columns`` refuses, a distance that is not integer text
        or is wider than 18 bytes (``int()`` reads what an int64 would
        overflow), or a sign with no digit after it but blanks, which
        the native parser reads as 0 and ``int()`` refuses."""
        from .. import native

        for sign in (b"-", b"+"):
            if sign in buf and (sign + b" " in buf or sign + b"\t" in buf):
                return None
        want = {1: native.BYTES, 2: native.INT64, 3: native.BYTES}
        if self.validation:
            want[4] = native.BYTES
        widths: List[int] = []
        got = _parse_columns(buf, delim, want, widths)
        if got is None or widths[2] > 18:
            return None
        return got[1]

    def _map(self, lines: List[str], delim_regex: str):
        """The mapper: each pair line split and grouped by its test id.
        Returns ``(groups, test_class, test_regr)``."""
        ccw = self.class_cond_weighted
        is_linreg = (self.prediction_mode == "regression"
                     and self.regression_method == "linearRegression")
        groups: Dict[str, List[Tuple]] = defaultdict(list)
        test_class: Dict[str, str] = {}
        test_regr: Dict[str, float] = {}
        for line in lines:
            items = split_line(line, delim_regex)
            if ccw:
                test_id, t_class, train_id = items[0], items[1], items[2]
                dist = int(items[3])
                train_class = items[4]
                post = float(items[5]) if items[5] else -1.0
                groups[test_id].append(
                    (dist, train_id, train_class, post, 0.0))
                test_class[test_id] = t_class
            else:
                train_id, test_id = items[0], items[1]
                dist = int(items[2])
                train_class = items[3]
                i = 4
                if self.validation:
                    test_class[test_id] = items[i]
                    i += 1
                r_in = 0.0
                if is_linreg:
                    r_in = float(items[i])
                    test_regr[test_id] = float(items[i + 1])
                groups[test_id].append(
                    (dist, train_id, train_class, -1.0, r_in))
        return groups, test_class, test_regr

    def _vote(self, groups, test_class, test_regr, out_path: str,
              counters: Counters) -> None:
        """Each group's decision (``classify_group``), the confusion
        counts in validation mode, and the prediction lines."""
        out: List[str] = []
        for test_id, neighbors in groups.items():
            line, predicted = self.classify_group(
                neighbors, test_id, test_class.get(test_id, ""),
                test_regr.get(test_id, 0.0))
            out.append(line)
            if self.conf_matrix is not None:
                self.conf_matrix.report(predicted,
                                        test_class.get(test_id, ""))
        if self.conf_matrix is not None:
            self.conf_matrix.to_counters(counters)
        write_output(out_path, out)

    def _vote_columns(self, cols: Dict[int, np.ndarray], out_path: str,
                      counters: Counters) -> None:
        """``_vote`` over the parsed columns (``_parse_pairs``), every
        group at once, with ``classify_group``'s decisions: groups are the
        test ids in first-seen order; a group's rows sorted stably by
        distance, its first ``top.match.count`` scored, each class's
        scores summed in that order in float64, as the per-group dict
        sums them; the winner is the largest sum above 0, ties to the
        class seen first; the test class is the group's last line's."""
        ids, dist, cls = cols[1], cols[2], cols[3]
        n = len(ids)
        # group codes in first-seen order, through the runs of equal ids
        run = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
        uniq, first, inv = np.unique(_keys(ids[run]), return_index=True,
                                     return_inverse=True)
        uniq = uniq.view(ids.dtype)
        by_first = np.argsort(first)
        code = np.empty(len(uniq), np.int64)
        code[by_first] = np.arange(len(uniq))
        grp = np.repeat(code[inv.reshape(-1)], np.diff(np.r_[run, n]))
        order = _stable_order(grp, dist)
        g = grp[order]
        start = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
        rank = np.arange(n) - np.repeat(start, np.diff(np.r_[start, n]))
        top = rank < self.top_match_count
        rows = order[top]
        names, cls_code = _codes(cls[rows])
        n_cls = len(names)
        pair, seen, at_pair = np.unique(g[top] * n_cls + cls_code,
                                        return_index=True,
                                        return_inverse=True)
        # bincount adds in row order, so each sum in rank order, in
        # float64: the per-group dict's sums to the last bit
        total = np.bincount(at_pair.reshape(-1), minlength=len(pair),
                            weights=self.neighborhood.scores(dist[rows]))
        label = np.append(names, b"")[_winners(pair, seen, total, n_cls)]
        fields = [uniq[by_first]]
        if self.validation:
            fields.append(cols[4][_last_rows(order, start)])
        fields.append(label)
        if self.conf_matrix is not None:
            _report_all(self.conf_matrix, label, fields[1])
            self.conf_matrix.to_counters(counters)
        # the lines as one fixed-width bytes array; the padding NULs go
        # with one replace, as the text holds none (``_parse_columns``)
        delim = self.config.field_delim_out().encode()
        line = fields[0]
        for f in fields[1:]:
            line = np.char.add(np.char.add(line, delim), f)
        text = np.char.add(line, b"\n").tobytes().replace(b"\0", b"")
        write_output(out_path, text.decode().split("\n")[:-1])


def _stable_order(grp: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """The rows by group, then by distance, ties in arrival order (as
    Python's ``sorted``): the distance job's lines come so already, and
    ``np.lexsort`` is stable."""
    same = grp[1:] == grp[:-1]
    if (grp[1:] >= grp[:-1]).all() and (dist[1:] >= dist[:-1])[same].all():
        return np.arange(len(grp))
    return np.lexsort((dist, grp))


def _winners(pair: np.ndarray, seen: np.ndarray, total: np.ndarray,
             n_cls: int) -> np.ndarray:
    """Each group's class code (``pair`` is ``group * n_cls + class``,
    sorted, each with the index of its first row, ``seen``, and its sum):
    the largest sum, ties to the class seen first, as ``_classify``
    reads the dict in insertion order; ``n_cls`` where no sum is above
    0."""
    grp = pair // n_cls
    start = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])
    best = np.maximum.reduceat(total, start)
    first = np.where(total == best[grp], seen, np.iinfo(np.int64).max)
    lead = np.minimum.reduceat(first, start)
    # ``seen`` holds each row index once: one lead a group
    win = pair[first == lead[grp]] % n_cls
    return np.where(best > 0, win, n_cls)


def _last_rows(order: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Each group's last row in arrival order: ``order`` holds the rows
    group by group, each group from its ``start``."""
    return np.maximum.reduceat(order, start)


def _keys(col: np.ndarray) -> np.ndarray:
    """A fixed-width bytes column as unsigned integers where its width
    is one of their sizes (equal values, equal integers, and faster to
    sort), else the column itself."""
    w = col.dtype.itemsize
    return col.view(f"u{w}") if w in (1, 2, 4, 8) else col


def _codes(col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A fixed-width bytes column's distinct values and each row's index
    among them."""
    keys = _keys(col)
    values = np.unique(keys)
    return values.view(col.dtype), np.searchsorted(values, keys)


def _report_all(cm: ConfusionMatrix, predicted: np.ndarray,
                actual: np.ndarray) -> None:
    """``cm.report`` for every pair of predicted and actual class
    (fixed-width bytes) at once."""
    def equals(col, value):
        return (col == value.encode() if isinstance(value, str)
                else np.zeros(len(col), bool))
    pred_pos = equals(predicted, cm.pos_class)
    act_pos = equals(actual, cm.pos_class)
    act_neg = equals(actual, cm.neg_class)
    cm.true_pos += int((pred_pos & act_pos).sum())
    cm.false_pos += int((pred_pos & ~act_pos).sum())
    cm.true_neg += int((~pred_pos & act_neg).sum())
    cm.false_neg += int((~pred_pos & ~act_neg).sum())


#: distance jobs that took the columnar emit, and vote jobs that took the
#: columnar vote
COLUMNAR_EMITS = 0
COLUMNAR_VOTES = 0
_COUNT_LOCK = threading.Lock()


def _count(name: str) -> None:
    """Add one to the module counter ``name`` under a lock, as
    ``ops.topk`` counts its launches."""
    with _COUNT_LOCK:
        globals()[name] += 1
