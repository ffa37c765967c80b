"""The native CSV ingest: one schema encode and the column parser.

Two C sources build into one library:

- ``chunk_encode.c`` (``chunk_encode``) is the port's only schema
  encode.  It parses, bins and encodes a buffer's every schema column in
  one pass straight into the encoder's matrices, with no Python string
  objects: each chunk of ``encode_path_chunks``, whatever its size, each
  buffer of the shared scan's ``encode_buffer_chunk``, and the one-shot
  ``encode_path`` with its id column.  Its contract: the caller passes a
  row capacity (a chunk's line budget, the row count ``csv_scan`` gives
  where an id column needs its width metered, else a bound from the
  buffer's length) and uninitialised outputs; the pass writes every
  cell, skips blank lines and returns the row count, or
  ``CHUNK_OVERFLOW`` (-6) before a row past the capacity.  Integer text
  in a float column (a sign, 1 to 15 digits, trailing blanks) converts
  exactly, bit for bit what ``strtod`` gives; other text goes through
  ``strtod``.  Its other codes: -2 unparseable, -3 vocabulary past
  ``max_uniq`` (one retry at ``1 << 22``), -4 out of memory, -5 a ragged
  row; on each, and on an overflow, the encode returns None.
- ``csv_ingest.c`` holds the field parsers and the categorical table the
  encode shares, and the column parser ``csv_parse`` with its sizing
  scan ``csv_scan``.

The encode runs on the calling thread.  The only parallelism of a parse
is ``ingest.parse.threads``, whose pool (core.parparse) runs one encode a
chunk on each worker.

``chunk_encode.c`` includes ``csv_ingest.c``, so one compiler call
(``cc -O3 -shared -fPIC``) builds the library into
``avenir_tpu_torch/build/libcsv_ingest-<digest>.so``, where ``digest``
covers both sources and the flags, so an edited source is rebuilt and a
current build is reused.  Nothing is built at import: the first call
that needs the library builds it.

It is host code, not a port of a TPU kernel.  Where the reference prints
a note and falls back to its numpy ingest when no compiler works, the
port raises :class:`NativeBuildError` with each compiler's output: a
training run never leaves the native path for want of a compiler.  Input
the fast path cannot take (a multi-character delimiter, ragged rows, an
unparseable number) still returns None from the encode calls, and the
callers fall back as the reference's do.

:func:`parse_csv_columns_buffer` binds the column parser (``csv_parse``):
the shared scan takes a job's few columns with it (core.multiscan's
``ChunkContext.columns``).

``ENCODE_CALLS`` counts the calls into ``chunk_encode`` (one per buffer;
a vocabulary-overflow retry adds one), so a run can show that its main
path went through the C parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "csv_ingest.c"
# includes SRC: the one translation unit the library is built from
CHUNK_SRC = _HERE / "chunk_encode.c"
BUILD_DIR = _HERE.parent / "build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "g++")

_lock = threading.Lock()
_lib = None

# column type codes shared with csv_ingest.c (BYTES: chunk_encode's id)
SKIP, INT64, FLOAT64, BYTES = 0, 1, 2, 3

BUCKET, FLOATVAL, CAT = 1, 2, 4      # chunk_encode column roles
Y_DEST = -2                          # feat_idx routing a CAT column to ycol

CHUNK_OVERFLOW = -6                  # chunk_encode: rows past the capacity

ENCODE_CALLS = 0
_count_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """No C compiler could build the library."""


def reset_call_counts() -> None:
    global ENCODE_CALLS
    with _count_lock:
        ENCODE_CALLS = 0


def _count_call() -> None:
    global ENCODE_CALLS
    with _count_lock:
        ENCODE_CALLS += 1


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + CHUNK_SRC.read_bytes()
                          + " ".join(CC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcsv_ingest-{digest}.so"


def _cc_run(cc: str, out: Path):
    """One compiler invocation (run under ``with_retries``: a transient
    OSError backs off and reattempts before the next compiler is
    tried)."""
    return subprocess.run([cc, *CC_FLAGS, "-o", str(out), str(CHUNK_SRC)],
                          capture_output=True, text=True, timeout=120)


def build() -> Path:
    """Compile the library unless a current build exists; returns its
    path.  Raises :class:`NativeBuildError` naming each compiler tried
    and what it printed."""
    from ..core.resilience import with_retries

    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    failures = []
    for cc in COMPILERS:
        try:
            proc = with_retries(_cc_run, cc, tmp, op="native.compile")
        except (OSError, subprocess.TimeoutExpired) as e:
            failures.append(f"{cc}: {type(e).__name__}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        failures.append(f"{cc} (exit {proc.returncode}):\n{proc.stderr}")
    raise NativeBuildError(f"cannot build {SRC}:\n" + "\n".join(failures))


def get_lib():
    """The loaded C library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = build()
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeBuildError(f"cannot load {so}: {e}") from None
        lib.csv_scan.restype = ctypes.c_longlong
        lib.csv_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.csv_parse.restype = ctypes.c_int
        lib.csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong]
        lib.chunk_encode.restype = ctypes.c_longlong
        lib.chunk_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char,
            ctypes.c_int,                        # n_cols
            ctypes.POINTER(ctypes.c_int),        # col_type
            ctypes.POINTER(ctypes.c_int),        # feat_idx
            ctypes.POINTER(ctypes.c_longlong),   # bucket_w
            ctypes.c_int, ctypes.c_longlong,     # F, row_cap
            ctypes.c_void_p, ctypes.c_void_p,    # x, values
            ctypes.c_void_p,                     # ycol
            ctypes.c_void_p, ctypes.c_void_p,    # uniq_start, uniq_len
            ctypes.c_void_p, ctypes.c_int,       # n_uniq, max_uniq
            ctypes.c_void_p, ctypes.c_int]       # ids, id_width
        _lib = lib
    return _lib


def _read_part(fp: str) -> bytes:
    """One part-file read attempt (a ``read`` fault-injection point, run
    under ``with_retries`` so transient I/O errors back off)."""
    from ..core import faultinject
    fi = faultinject.get_injector()
    if fi is not None:
        fi.fire("read")
    with open(fp, "rb") as fh:
        return fh.read()


def _read_buffer(path: str) -> bytes:
    """A file, or every part file of a job-output directory joined by
    newlines: the retried read every chunked scan starts with."""
    from ..core.io import _input_files
    from ..core.resilience import with_retries
    return b"\n".join(with_retries(_read_part, fp, op="ingest.read")
                      for fp in _input_files(path))


def parse_csv_columns(path: str, col_types, delim: str = ","
                      ) -> Optional[Tuple[int, Dict[int, np.ndarray]]]:
    """A delimited file (or part-file directory) parsed into typed numpy
    columns: ``col_types[i]`` is SKIP, INT64, FLOAT64 or BYTES for file
    column ``i``, and ``col_types`` covers every column of the file.
    Returns ``(n_rows, {ordinal: array})``, or None when the fast path
    does not apply (a multi-character delimiter, ragged rows, an
    unparseable number); callers then parse in Python."""
    if len(delim) != 1:
        return None
    get_lib()
    return parse_csv_columns_buffer(_read_buffer(path), col_types, delim)


def parse_csv_columns_buffer(buf: bytes, col_types, delim: str = ",",
                             widths: Optional[List[int]] = None
                             ) -> Optional[Tuple[int, Dict[int, np.ndarray]]]:
    """:func:`parse_csv_columns` over an in-memory buffer: the per-chunk
    form the shared scan uses to take only the columns a job reads, with
    no field matrix (BYTES columns come back as fixed-width ``S``
    arrays, FLOAT64 through C ``strtod``, the values ``float()`` gives).
    A ``widths`` list, where given, is filled with each column's widest
    field in bytes."""
    lib = get_lib()
    if len(delim) != 1:
        return None
    n_cols = len(col_types)
    bdelim = ctypes.c_char(delim.encode())
    scan_w = (ctypes.c_int * n_cols)(*([0] * n_cols))
    n_rows = lib.csv_scan(buf, len(buf), bdelim, n_cols, scan_w)
    if n_rows < 0:
        return None
    if widths is not None:
        widths[:] = list(scan_w)
    cols: Dict[int, np.ndarray] = {}
    outs = (ctypes.c_void_p * n_cols)(*([None] * n_cols))
    for j, t in enumerate(col_types):
        if t == INT64:
            a = np.empty(n_rows, dtype=np.int64)
        elif t == FLOAT64:
            a = np.empty(n_rows, dtype=np.float64)
        elif t == BYTES:
            a = np.empty(n_rows, dtype=f"S{max(int(scan_w[j]), 1)}")
        else:
            continue
        cols[j] = a
        outs[j] = a.ctypes.data
    rc = lib.csv_parse(buf, len(buf), bdelim, n_cols,
                       (ctypes.c_int * n_cols)(*col_types), scan_w, outs,
                       n_rows)
    if rc != 0:
        return None
    return int(n_rows), cols


def encode_schema(path: str, col_specs, n_file_cols: int, n_feat: int,
                  has_class: bool, id_ordinal: int = -1, delim: str = ",",
                  max_uniq: int = 1 << 16):
    """Single-pass schema-aware encode of a whole file (or part-file
    directory); see :func:`encode_schema_buffer`."""
    if len(delim) != 1:
        return None
    get_lib()
    return encode_schema_buffer(_read_buffer(path), col_specs, n_file_cols,
                                n_feat, has_class, id_ordinal, delim,
                                max_uniq)


def encode_schema_buffer(buf: bytes, col_specs, n_file_cols: int,
                         n_feat: int, has_class: bool, id_ordinal: int = -1,
                         delim: str = ",", max_uniq: int = 1 << 16,
                         row_capacity: Optional[int] = None):
    """Encode one in-memory buffer through ``chunk_encode``, on the
    calling thread.  Each of ``col_specs`` is ``(file_ordinal, role,
    feat_idx, extra)``: ``role`` BUCKET (``extra`` the bucket width),
    FLOATVAL or CAT, and ``feat_idx`` the destination feature column
    (Y_DEST for the class attribute, a CAT column).  ``id_ordinal``, where
    given, is the column whose raw bytes come back as the row ids.

    Returns ``(n_rows, x, values, y, ids, cat_uniques)``, where ``x``
    holds -1 in each float column, ``ids`` is a fixed-width ``S`` array
    (None without an id column) and ``cat_uniques[ordinal]`` is the
    first-seen list of raw byte values of each categorical column (the
    codes in ``x``/``y`` index into it), or None when the input does not
    fit the fast path, or the specs do not write every output cell once.

    ``row_capacity``, the buffer's line budget where the caller knows it,
    sizes the outputs, else a bound from the buffer's length does; with
    an id column, ``csv_scan``'s row count does, as it meters the ids'
    width."""
    lib = get_lib()
    if len(delim) != 1:
        return None
    bdelim = ctypes.c_char(delim.encode())

    col_type = [SKIP] * n_file_cols
    feat_idx = [-1] * n_file_cols
    bucket_w = [1] * n_file_cols
    for ordinal, role, fj, extra in col_specs:
        if ordinal >= n_file_cols or role not in (BUCKET, FLOATVAL, CAT):
            return None
        col_type[ordinal] = role
        feat_idx[ordinal] = fj
        if role == BUCKET:
            if extra <= 0:
                return None
            bucket_w[ordinal] = extra
    if id_ordinal >= n_file_cols:
        return None
    if id_ordinal >= 0:
        col_type[id_ordinal] = BYTES
    if not _fills_every_cell(col_type, feat_idx, n_feat, has_class):
        return None
    id_width = 0
    if id_ordinal >= 0:
        widths = (ctypes.c_int * n_file_cols)(*([0] * n_file_cols))
        row_capacity = lib.csv_scan(buf, len(buf), bdelim, n_file_cols,
                                    widths)
        if row_capacity < 0:
            return None
        id_width = max(int(widths[id_ordinal]), 1)
    args = (lib, buf, bdelim, col_type, feat_idx, bucket_w, n_feat,
            has_class, row_capacity, id_width)
    res = _encode_one_pass(*args, max_uniq)
    if res == -3 and max_uniq < (1 << 22):  # vocab overflow: one retry, 64x
        res = _encode_one_pass(*args, 1 << 22)
    return None if isinstance(res, int) else res


def _fills_every_cell(col_type, feat_idx, n_feat: int,
                      has_class: bool) -> bool:
    """True when the file columns write every output cell ``chunk_encode``
    leaves to them: each feature column once, and the class column
    exactly when there is one, from a categorical column."""
    roles = [(t, j) for t, j in zip(col_type, feat_idx)
             if t in (BUCKET, FLOATVAL, CAT)]
    feats = sorted(j for _, j in roles if j != Y_DEST)
    y_roles = [t for t, j in roles if j == Y_DEST]
    return (feats == list(range(n_feat))
            and y_roles == ([CAT] if has_class else []))


def _cat_uniques(buf: bytes, cat_ordinals, uniq_start, uniq_len, n_uniq):
    """``{ordinal: [first-seen raw bytes]}`` from row ``i`` of the
    vocabulary scratch for the ``i``-th of ``cat_ordinals``."""
    out: Dict[int, List[bytes]] = {}
    for i, o in enumerate(cat_ordinals):
        k = int(n_uniq[i])
        out[o] = [bytes(buf[int(s):int(s) + int(l)])
                  for s, l in zip(uniq_start[i, :k], uniq_len[i, :k])]
    return out


def _encode_one_pass(lib, buf, bdelim, col_type, feat_idx, bucket_w, n_feat,
                     has_class, row_capacity, id_width, max_uniq):
    """``chunk_encode`` into uninitialised outputs of ``row_capacity``
    rows, capped by the most rows ``buf`` can hold (a row of n columns
    takes at least max(n, 2) bytes with its newline).  Returns the result
    tuple or the negative code."""
    n_cols = len(col_type)
    bound = (len(buf) + 1) // max(n_cols, 2)
    cap = bound if row_capacity is None else min(int(row_capacity), bound)
    x = np.empty((cap, n_feat), dtype=np.int32)
    values = np.empty((cap, n_feat), dtype=np.float64)
    y = np.empty(cap, dtype=np.int32) if has_class else None
    ids = np.empty(cap, dtype=f"S{id_width}") if id_width else None
    cat_ordinals = [o for o in range(n_cols) if col_type[o] == CAT]
    n_cat = max(len(cat_ordinals), 1)
    uniq_start = np.empty((n_cat, max_uniq), dtype=np.int64)
    uniq_len = np.empty((n_cat, max_uniq), dtype=np.int32)
    n_uniq = np.empty(n_cat, dtype=np.int32)
    _count_call()
    n = lib.chunk_encode(
        buf, len(buf), bdelim, n_cols,
        (ctypes.c_int * n_cols)(*col_type),
        (ctypes.c_int * n_cols)(*feat_idx),
        (ctypes.c_longlong * n_cols)(*bucket_w),
        n_feat, cap, x.ctypes.data, values.ctypes.data,
        y.ctypes.data if y is not None else None,
        uniq_start.ctypes.data, uniq_len.ctypes.data, n_uniq.ctypes.data,
        max_uniq, ids.ctypes.data if ids is not None else None, id_width)
    if n < 0:
        return int(n)
    return (int(n), x[:n], values[:n], y[:n] if y is not None else None,
            ids[:n] if ids is not None else None,
            _cat_uniques(buf, cat_ordinals, uniq_start, uniq_len, n_uniq))
