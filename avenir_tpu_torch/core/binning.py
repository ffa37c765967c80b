"""Columnar ingest: delimited records + FeatureSchema -> binned int32
matrix.  The port's copy of ``avenir_tpu/core/binning.py``.

Binning semantics (identical to the reference package):

- categorical -> stable vocabulary index: declared ``cardinality`` order
  first, then discovered values in first-seen order;
- numeric with ``bucketWidth`` -> ``int(value) / bucketWidth`` truncated
  toward zero; a column whose smallest bin is negative is shifted by a
  recorded per-column ``bin_offset`` so count tables stay zero-based, and
  ``bin_label`` reverses the shift;
- numeric without ``bucketWidth`` -> raw value in a float column (-1 in
  ``x``), for the trainers' Gaussian moments.

The chunked encoder ``encode_path_chunks`` and the one-shot
``encode_path`` run the native C parser (``avenir_tpu_torch/native``, a
copy of the reference's): one pass per chunk parses, bins and encodes
every schema column straight into the matrices.  Chunks are cut at line
ends over the whole buffer (``pipeline.row_chunk_ends``), codes come from
the shared vocabularies, so they are stable across chunks, and the
vocabulary order is first-seen order over the whole input, whatever
``ingest.parse.threads`` is: the parse pool hands chunks back in order
and every vocabulary merge runs on the caller's thread.  The chunked
encoder also carries the resilience hooks: a resume offset, per-chunk
fault points, and per-row salvage of a chunk the C parser rejects.

``plain_encode_path_chunks`` is the numpy version of the chunked encoder
(split lines, then one numpy pass per column), kept as the plain
reference for the tests; the one-shot numpy path (``encode`` over
``io.read_field_matrix``) stays the fallback for input the C parser
cannot take, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .schema import FeatureField, FeatureSchema


class ChunkedEncodeUnsupported(Exception):
    """The chunked encoder cannot serve this input; callers fall back to
    the one-shot ``encode_path``."""


def _rows_hint(chunk: bytes) -> Optional[int]:
    """The exact row count of a byte chunk when it is cheap to prove (no
    blank lines), which lets the C parser skip its sizing pass; None
    otherwise.  The newline count equals the parser's row count only
    when no line is blank (the parser skips blank lines)."""
    if b"\n\n" in chunk or chunk.startswith(b"\n"):
        return None
    n = chunk.count(b"\n")
    return n if chunk.endswith(b"\n") else n + 1


class Vocab:
    """Stable string->index mapping for one categorical column."""

    def __init__(self, declared: Sequence[str] = ()):
        self.values: List[str] = list(declared)
        self.index: Dict[str, int] = {v: i for i, v in enumerate(self.values)}

    def add(self, value: str) -> int:
        i = self.index.get(value)
        if i is None:
            i = len(self.values)
            self.values.append(value)
            self.index[value] = i
        return i

    def __getitem__(self, value: str) -> int:
        return self.index[value]

    def get(self, value: str, default: int = -1) -> int:
        return self.index.get(value, default)

    def __len__(self) -> int:
        return len(self.values)


@dataclass
class EncodedDataset:
    """The columnar view of one delimited-text dataset.

    - ``x``: int32 [n, F] bin index per binned feature column (-1 where the
      column is an unbinned numeric).
    - ``values``: float64 [n, F] raw numeric value per column (0 where
      categorical).
    - ``y``: int32 [n] class-attribute vocab index.
    - ``num_bins``: per-column bin counts (count-table extents).
    """

    schema: FeatureSchema
    feature_fields: List[FeatureField]
    x: np.ndarray
    values: np.ndarray
    y: np.ndarray
    num_bins: List[int]
    bin_offset: np.ndarray           # int32 [F]: subtracted from raw bins
    binned_mask: np.ndarray          # bool [F]: column is binned
    vocabs: Dict[int, Vocab]         # per feature ordinal (categorical cols)
    class_vocab: Vocab

    @property
    def n_rows(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.x.shape[1])

    def bin_label(self, col: int, b: int) -> str:
        """Reverse-map a bin index to the reference's textual bin id."""
        f = self.feature_fields[col]
        if f.is_categorical():
            return self.vocabs[f.ordinal].values[b]
        return str(b + int(self.bin_offset[col]))


class DatasetEncoder:
    """Encodes delimited records per a FeatureSchema; owns the vocabularies
    so that every chunk (and the train and predict paths) share one stable
    encoding."""

    def __init__(self, schema: FeatureSchema):
        self.schema = schema
        self.feature_fields = schema.feature_fields()
        self.class_field = schema.class_attr_field()
        self.id_field = schema.id_field()
        self.vocabs: Dict[int, Vocab] = {
            f.ordinal: Vocab(f.cardinality or ())
            for f in self.feature_fields if f.is_categorical()
        }
        self.class_vocab = Vocab(self.class_field.cardinality or ())

    def _encode_categorical(self, vocab: Vocab, col: np.ndarray) -> np.ndarray:
        """Vectorized vocab encode of one string column.  New values are
        registered in first-seen order (``np.unique`` sorts, so the
        first-occurrence indices recover document order)."""
        uniq, first, inv = np.unique(col, return_index=True,
                                     return_inverse=True)
        lut = np.empty(len(uniq), dtype=np.int32)
        for k in np.argsort(first, kind="stable"):
            lut[k] = vocab.add(str(uniq[k]))
        return lut[inv.reshape(-1)]

    def _encode_columns(self, records):
        """``(x, values, y)`` of ``records`` (a 2-D string ndarray or a
        list of field lists), with raw, unshifted bucket bins."""
        ffields = self.feature_fields
        n_f = len(ffields)

        if isinstance(records, np.ndarray) and records.ndim == 2:
            arr = records
            n = arr.shape[0]

            def col(ordinal: int) -> np.ndarray:
                if ordinal >= arr.shape[1]:
                    raise IndexError(
                        f"schema ordinal {ordinal} out of range for "
                        f"{arr.shape[1]}-column input")
                return arr[:, ordinal]
        else:
            rows = records if isinstance(records, list) else [list(r) for r in records]
            n = len(rows)

            def col(ordinal: int) -> np.ndarray:
                return np.asarray([r[ordinal] for r in rows], dtype=str)

        x = np.zeros((n, n_f), dtype=np.int32)
        values = np.zeros((n, n_f), dtype=np.float64)
        for j, f in enumerate(ffields):
            if f.is_categorical():
                if n:
                    x[:, j] = self._encode_categorical(
                        self.vocabs[f.ordinal], col(f.ordinal))
            elif f.is_bucket_width_defined():
                if n:
                    v = col(f.ordinal).astype(np.int64)
                    w = int(f.bucketWidth)
                    # Java integer division truncates toward zero
                    x[:, j] = np.where(v < 0, -((-v) // w), v // w)
                    values[:, j] = v
            else:
                x[:, j] = -1
                if n:
                    values[:, j] = col(f.ordinal).astype(np.float64)

        y = (self._encode_categorical(self.class_vocab,
                                      col(self.class_field.ordinal))
             if n else np.zeros(0, dtype=np.int32))
        return x, values, y

    def encode(self, records) -> EncodedDataset:
        """Encode records (a 2-D string ndarray or an iterable of field
        lists) into the columnar form, one numpy pass per schema column."""
        return self._assemble(*self._encode_columns(records))

    def _assemble(self, x, values, y) -> EncodedDataset:
        """Negative-bin shift, bin extents, dataset packing."""
        ffields = self.feature_fields
        n = x.shape[0]

        bin_offset = np.zeros(len(ffields), dtype=np.int32)
        for j, f in enumerate(ffields):
            if f.is_bucket_width_defined() and n:
                lo = int(x[:, j].min())
                if lo < 0:
                    bin_offset[j] = lo
                    x[:, j] -= lo

        num_bins = []
        for j, f in enumerate(ffields):
            if f.is_categorical():
                num_bins.append(len(self.vocabs[f.ordinal]))
            elif f.is_bucket_width_defined():
                declared = f.num_bins() if f.max is not None else 0
                seen = int(x[:, j].max()) + 1 if n else 0
                num_bins.append(max(declared, seen))
            else:
                num_bins.append(0)

        binned_mask = np.array(
            [f.is_categorical() or f.is_bucket_width_defined()
             for f in ffields], dtype=bool)
        return EncodedDataset(
            schema=self.schema, feature_fields=ffields, x=x, values=values,
            y=y, num_bins=num_bins, bin_offset=bin_offset,
            binned_mask=binned_mask, vocabs=self.vocabs,
            class_vocab=self.class_vocab)

    # -- the native C encode --------------------------------------------

    def _native_specs(self, path: str, delim: str):
        """``(specs, n_cols)`` for the C encode of ``path``, or None when
        the input does not fit it (no input file, an empty first line, a
        schema misfit)."""
        from . import io as _io

        files = _io._input_files(path)
        if not files:
            return None
        with open(files[0], "r") as fh:
            first = fh.readline().rstrip("\n")
        if not first:
            return None
        return self._specs_for_cols(first.count(delim) + 1)

    def _specs_for_cols(self, n_cols: int):
        """``(specs, n_cols)`` for the C encode of ``n_cols``-column
        input, or None on a schema misfit.  Row ids are never parsed: the
        port's dataset keeps none."""
        from .. import native

        specs = []
        for j, f in enumerate(self.feature_fields):
            if f.is_categorical():
                specs.append((f.ordinal, native.CAT, j, 0))
            elif f.is_bucket_width_defined():
                specs.append((f.ordinal, native.BUCKET, j, int(f.bucketWidth)))
            else:
                specs.append((f.ordinal, native.FLOATVAL, j, 0))
        specs.append((self.class_field.ordinal, native.CAT, native.Y_DEST, 0))
        if self.id_field is not None and self.id_field.ordinal >= n_cols:
            return None     # the one-shot path then reports the misfit
        return specs, n_cols

    def _remap_native(self, res):
        """Map the C parser's first-seen codes to the stable vocabulary
        ids (declared cardinality first, then first-seen, the order
        ``Vocab.add`` gives); returns ``(n, x, values, y)``."""
        n, x, values, y, _, cat_uniques = res
        for j, f in enumerate(self.feature_fields):
            if f.is_categorical():
                x[:, j] = self._cat_lut(self.vocabs[f.ordinal],
                                        cat_uniques[f.ordinal])[x[:, j]]
            elif not f.is_bucket_width_defined():
                x[:, j] = -1
        if n:
            y = self._cat_lut(self.class_vocab,
                              cat_uniques[self.class_field.ordinal])[y]
        else:
            y = np.zeros(0, dtype=np.int32)
        return n, x, values, y

    @staticmethod
    def _cat_lut(vocab: Vocab, uniques) -> np.ndarray:
        lut = np.empty(max(len(uniques), 1), dtype=np.int32)
        for k, u in enumerate(uniques):
            lut[k] = vocab.add(u.decode())
        return lut

    def _encode_path_native(self, path: str,
                            delim: str) -> Optional[EncodedDataset]:
        """The one-shot C encode of the whole input, or None when the
        input does not fit the C parser."""
        from .. import native

        sp = self._native_specs(path, delim)
        if sp is None:
            return None
        specs, n_cols = sp
        res = native.encode_schema(path, specs, n_cols,
                                   len(self.feature_fields), True,
                                   id_ordinal=-1, delim=delim)
        if res is None:
            return None
        _, x, values, y = self._remap_native(res)
        return self._assemble(x, values, y)

    def encode_buffer_chunk(self, chunk: bytes, delim: str = ","):
        """The C encode of one raw byte chunk with the shared
        vocabularies: ``(x, values, y, n)`` with raw, unshifted bucket
        bins, the per-chunk step of ``encode_path_chunks`` for a caller
        that owns the buffer.  None when the C path does not apply (a
        regex delimiter, a schema misfit, a parse failure)."""
        from .io import is_plain_delim
        from .obs import get_tracer
        from .pipeline import first_nonblank_line
        from .. import native

        if not is_plain_delim(delim):
            return None
        first = first_nonblank_line(chunk)
        if not first:
            F = len(self.feature_fields)
            return (np.zeros((0, F), np.int32), np.zeros((0, F)),
                    np.zeros(0, np.int32), 0)
        sp = self._specs_for_cols(first.count(delim.encode()) + 1)
        if sp is None:
            return None
        specs, n_cols = sp
        with get_tracer().span("ingest.parse", bytes=len(chunk),
                               native=True):
            res = native.encode_schema_buffer(
                chunk, specs, n_cols, len(self.feature_fields), True,
                id_ordinal=-1, delim=delim, n_rows_hint=_rows_hint(chunk))
            if res is None:
                return None
            n, x, values, y = self._remap_native(res)
        return x, values, y, n

    def encode_path_chunks(self, path: str, delim: str = ",",
                           chunk_bytes: int = 48 << 20,
                           chunk_rows: Optional[int] = None,
                           start_offset: int = 0,
                           with_offsets: bool = False,
                           salvage=None,
                           parse_threads: int = 1):
        """Generator over C-encoded chunks of the input, cut at line
        ends: yields ``(x, values, y, n_rows)`` per chunk with raw,
        unshifted bucket bins (callers own the negative-bin guard) and
        the shared vocabularies.  ``chunk_rows`` selects chunks of that
        many lines (blank lines count toward a chunk's line budget but
        not its rows); otherwise chunks are about ``chunk_bytes`` long.
        Raises ``ChunkedEncodeUnsupported`` for a regex delimiter or input
        the C parser rejects; callers then fall back to ``encode_path``.

        ``start_offset`` (a checkpointed chunk-end byte offset) skips the
        chunks already folded; boundaries derive from the whole buffer,
        so the resumed chunking is the uninterrupted one.
        ``with_offsets`` yields ``(x, values, y, n, chunk_index,
        end_offset)`` for checkpoint tokens.  ``salvage``
        (``core.resilience.salvage_chunk``) replaces the whole-chunk
        failure with per-row quarantine of the malformed rows.  Each
        chunk passes the fault points (``pipeline.chunk_faults``).

        ``parse_threads`` > 1 fans the per-chunk C encode across a
        ``core.parparse.OrderedParsePool`` (``ingest.parse.threads``).
        Workers run only the native call, which releases the GIL; fault
        points fire at submission, and vocabulary merge, salvage and
        quarantine run here in chunk order, so the output and the
        vocabulary order are the serial scan's."""
        from .io import is_plain_delim
        from .obs import get_tracer
        from . import pipeline
        from .. import native

        tracer = get_tracer()
        if not is_plain_delim(delim):
            raise ChunkedEncodeUnsupported("regex delimiter")
        # a non-positive chunk size would loop forever on empty chunks
        chunk_bytes = max(int(chunk_bytes), 1)
        sp = self._native_specs(path, delim)
        if sp is None:
            raise ChunkedEncodeUnsupported("native encode unavailable")
        specs, n_cols = sp
        with tracer.span("ingest.read", path=path):
            buf = native._read_buffer(path)
        row_ends = None
        if chunk_rows is not None:
            row_ends = (pipeline.row_chunk_ends(buf, max(int(chunk_rows), 1))
                        if buf else [])
        n_feat = len(self.feature_fields)
        parse_threads = max(int(parse_threads), 1)

        def _chunks():
            # produced on the consumer's thread (the pool calls next()
            # there), so the fault points keep their serial semantics
            pos = 0
            idx = 0
            while pos < len(buf):
                if row_ends is not None:
                    end = int(row_ends.pop(0))
                else:
                    end = min(pos + chunk_bytes, len(buf))
                    if end < len(buf):
                        nl = buf.find(b"\n", end)
                        end = len(buf) if nl < 0 else nl + 1
                if end > start_offset:
                    yield idx, end, pipeline.chunk_faults(buf[pos:end], idx)
                pos = end
                idx += 1

        def _parse(item):
            # the native call alone, no shared Python state; the inner
            # pthread fan-out is 1 when the pool is parallel, so the two
            # levels do not oversubscribe the host
            cidx, end, chunk = item
            res = native.encode_schema_buffer(
                chunk, specs, n_cols, n_feat, True, id_ordinal=-1,
                delim=delim, n_rows_hint=_rows_hint(chunk),
                n_threads=1 if parse_threads > 1 else None)
            return cidx, end, chunk, res

        if parse_threads > 1:
            from .parparse import OrderedParsePool
            parsed = OrderedParsePool(_parse, parse_threads).map(_chunks())
        else:
            parsed = map(_parse, _chunks())
        try:
            for cidx, end, chunk, res in parsed:
                with tracer.span("ingest.parse", bytes=len(chunk),
                                 threads=parse_threads):
                    if res is None:
                        if salvage is None:
                            raise ChunkedEncodeUnsupported(
                                "native encode failed")
                        x, values, y, n = salvage(chunk)
                    else:
                        n, x, values, y = self._remap_native(res)
                if with_offsets:
                    yield x, values, y, n, cidx, end
                else:
                    yield x, values, y, n
        finally:
            closer = getattr(parsed, "close", None)
            if closer is not None:
                closer()

    def plain_encode_path_chunks(self, path: str, delim: str = ",",
                                 chunk_bytes: int = 48 << 20,
                                 chunk_rows: Optional[int] = None):
        """``encode_path_chunks`` in numpy, the plain version the tests
        hold the C path against: the same chunks and the same
        ``(x, values, y, n_rows)``, made by splitting each chunk's lines
        and encoding one column at a time."""
        from .. import native
        from .io import is_plain_delim
        from .pipeline import row_chunk_ends, split_field_lines

        if not is_plain_delim(delim):
            raise ChunkedEncodeUnsupported("regex delimiter")
        buf = native._read_buffer(path)
        if chunk_rows is not None:
            ends = row_chunk_ends(buf, max(int(chunk_rows), 1)) if buf else []
        else:
            step = max(int(chunk_bytes), 1)
            ends, pos = [], 0
            while pos < len(buf):
                end = min(pos + step, len(buf))
                if end < len(buf):
                    nl = buf.find(b"\n", end)
                    end = len(buf) if nl < 0 else nl + 1
                ends.append(end)
                pos = end
        F = len(self.feature_fields)
        pos = 0
        for end in ends:
            lines = [l for l in buf[pos:end].decode().split("\n") if l]
            pos = end
            if not lines:
                yield (np.zeros((0, F), np.int32), np.zeros((0, F)),
                       np.zeros(0, np.int32), 0)
                continue
            fields, bulk = split_field_lines(lines, delim)
            if not bulk:
                raise ChunkedEncodeUnsupported("ragged rows")
            x, values, y = self._encode_columns(fields)
            yield x, values, y, len(lines)

    def encode_path(self, path: str, delim_regex: str = ",") -> EncodedDataset:
        """The one-shot encode: the C parser where the input fits it,
        else the numpy path (a regex delimiter, ragged or unparseable
        rows)."""
        from .io import is_plain_delim, read_field_matrix, read_records
        if is_plain_delim(delim_regex):
            try:
                ds = self._encode_path_native(path, delim_regex)
            except (ValueError, OSError):
                ds = None
            if ds is not None:
                return ds
        arr = read_field_matrix(path, delim_regex)
        if arr is not None:
            return self.encode(arr)
        return self.encode(list(read_records(path, delim_regex)))
