"""Delimited text from integer columns, built as one byte buffer with
numpy: no Python loop over rows, so a few million rows take a fraction of
a second.

A column is one of

- ``("table", table, codes)``: ``table`` is a list of byte strings (the
  column's possible values) and ``codes`` an integer array of indices
  into it, one per row;
- ``("digits", prefix, numbers, width)``: ``prefix`` then ``numbers``
  zero-padded to ``width`` digits (identifiers).

``present`` (an optional boolean array per row) leaves a column and its
separator out of the rows where it is False: trailing optional columns
give rows of different lengths.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _table_bytes(table: Sequence[bytes]):
    width = max(len(t) for t in table)
    mat = np.zeros((len(table), width), np.uint8)
    lens = np.zeros(len(table), np.int64)
    for i, t in enumerate(table):
        mat[i, :len(t)] = np.frombuffer(t, np.uint8)
        lens[i] = len(t)
    return mat, lens


def int_table(hi: int) -> List[bytes]:
    """Decimal text of 0..hi."""
    return [str(i).encode() for i in range(hi + 1)]


def join_rows(columns: list, present: Optional[list] = None,
              delim: bytes = b",") -> bytes:
    """The rows' text, ``delim`` between fields and a newline after each
    row."""
    n = None
    prepared = []
    for col in columns:
        if col[0] == "table":
            mat, lens = _table_bytes(col[1])
            codes = np.asarray(col[2], np.int64)
            prepared.append(("table", mat, lens, codes))
            n = len(codes)
        elif col[0] == "digits":
            prefix, numbers, width = col[1], np.asarray(col[2], np.int64), col[3]
            digits = np.zeros((len(numbers), len(prefix) + width), np.uint8)
            digits[:, :len(prefix)] = np.frombuffer(prefix, np.uint8)
            v = numbers.copy()
            for k in range(width - 1, -1, -1):
                digits[:, len(prefix) + k] = 48 + (v % 10)
                v //= 10
            prepared.append(("fixed", digits))
            n = len(numbers)
        else:
            raise ValueError(f"unknown column kind {col[0]!r}")
    present = present or [None] * len(columns)
    row_len = np.zeros(n, np.int64)
    field_len = []
    for k, p in enumerate(prepared):
        ln = (np.full(n, p[1].shape[1], np.int64) if p[0] == "fixed"
              else p[2][p[3]])
        if present[k] is not None:
            ln = np.where(present[k], ln, 0)
        field_len.append(ln)
        sep = 1 if present[k] is None else np.asarray(present[k], np.int64)
        row_len += ln + sep          # a separator, or the newline at the end
    ends = np.cumsum(row_len)
    buf = np.full(int(ends[-1]) if n else 0, ord(delim), np.uint8)
    pos = ends - row_len
    for k, p in enumerate(prepared):
        ln = field_len[k]
        if p[0] == "fixed":
            width = p[1].shape[1]
            idx = pos[:, None] + np.arange(width)[None, :]
            m = ln[:, None] > np.arange(width)[None, :]
            buf[idx[m]] = p[1][m]
        else:
            mat, codes = p[1], p[3]
            for j in range(mat.shape[1]):
                m = ln > j
                buf[pos[m] + j] = mat[codes[m], j]
        pos = pos + ln + (1 if present[k] is None
                          else np.asarray(present[k], np.int64))
    if n:
        buf[ends - 1] = ord("\n")
    return buf.tobytes()
