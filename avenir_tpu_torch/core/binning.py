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

The reference's chunked encoder is a native C parser; the port's
``encode_path_chunks`` is numpy: it splits the input into row (or byte)
chunks and column-encodes each with the shared vocabularies, so codes are
stable across chunks and vocabulary order is first-seen order over the
whole input.  Porting the C parser waits for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .schema import FeatureField, FeatureSchema


class ChunkedEncodeUnsupported(Exception):
    """The chunked encoder cannot serve this input; callers fall back to
    the one-shot ``encode_path``."""


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

    def encode_path_chunks(self, path: str, delim: str = ",",
                           chunk_bytes: int = 48 << 20,
                           chunk_rows: Optional[int] = None):
        """Generator over encoded chunks of the input: yields
        ``(x, values, y, n_rows)`` per chunk with raw, unshifted bucket bins
        (callers own the negative-bin guard).  ``chunk_rows`` selects
        chunks of that many lines (blank lines count toward a chunk's line
        budget but not its rows); otherwise chunks are about
        ``chunk_bytes`` long, cut at line ends.  Raises
        ``ChunkedEncodeUnsupported`` for a regex delimiter or a ragged
        chunk; callers then fall back to ``encode_path``."""
        from .io import is_plain_delim, read_buffer
        from .pipeline import row_chunk_ends, split_field_lines

        if not is_plain_delim(delim):
            raise ChunkedEncodeUnsupported("regex delimiter")
        buf = read_buffer(path)
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
        from .io import read_field_matrix, read_records
        arr = read_field_matrix(path, delim_regex)
        if arr is not None:
            return self.encode(arr)
        return self.encode(list(read_records(path, delim_regex)))
