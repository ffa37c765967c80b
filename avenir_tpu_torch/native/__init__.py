"""The native CSV ingest: the port's copy of ``avenir_tpu/native``.

``csv_ingest.c`` (a verbatim copy of the reference's source) parses a
delimited byte buffer straight into the encoder's matrices: bucket bins
truncated toward zero, float values, and first-seen categorical codes,
with no Python string objects.  This module builds it with the system C
compiler (``cc -O3 -pthread -shared -fPIC``) into
``avenir_tpu_torch/build/libcsv_ingest-<digest>.so``, where ``digest``
covers the source and the flags, so an edited source is rebuilt and a
current build is reused.  Nothing is built at import: the first call that
needs the library builds it.

It is host code, not a port of a TPU kernel.  Where the reference prints
a note and falls back to its numpy ingest when no compiler works, the
port raises :class:`NativeBuildError` with each compiler's output: a
training run never leaves the native path for want of a compiler.  Input
the fast path cannot take (a multi-character delimiter, ragged rows, an
unparseable number) still returns None from the encode calls, and the
callers fall back as the reference's do.

:func:`parse_csv_columns_buffer` binds the source's column parser
(``csv_parse``): the shared scan takes a job's few columns with it
(core.multiscan's ``ChunkContext.columns``).

``ENCODE_CALLS`` counts the calls into the C encoder (one per buffer; a
vocabulary-overflow retry adds one), so a run can show that its main
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
BUILD_DIR = _HERE.parent / "build"
CC_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "g++")

_lock = threading.Lock()
_lib = None

# column type codes shared with csv_ingest.c
SKIP, INT64, FLOAT64, BYTES = 0, 1, 2, 3

# buffers at least this large take the multithreaded encode path
MT_MIN_BYTES = 4 << 20
# thread count override (None = min(8, cores)); tests force >1 so the
# pthread path is exercised on any host
MT_THREADS = None
BUCKET, FLOATVAL, CAT = 1, 2, 4      # csv_encode column roles
Y_DEST = -2                          # feat_idx routing a CAT column to ycol

ENCODE_CALLS = 0
_count_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """No C compiler could build ``csv_ingest.c``."""


def reset_call_counts() -> None:
    global ENCODE_CALLS
    with _count_lock:
        ENCODE_CALLS = 0


def _count_call() -> None:
    global ENCODE_CALLS
    with _count_lock:
        ENCODE_CALLS += 1


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()
                          + " ".join(CC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcsv_ingest-{digest}.so"


def _cc_run(cc: str, out: Path):
    """One compiler invocation (run under ``with_retries``: a transient
    OSError backs off and reattempts before the next compiler is
    tried)."""
    return subprocess.run([cc, *CC_FLAGS, "-o", str(out), str(SRC)],
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
        lib.csv_encode.restype = ctypes.c_int
        lib.csv_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char,
            ctypes.c_int,                        # n_cols
            ctypes.POINTER(ctypes.c_int),        # col_type
            ctypes.POINTER(ctypes.c_int),        # feat_idx
            ctypes.POINTER(ctypes.c_longlong),   # bucket_w
            ctypes.c_int, ctypes.c_longlong,     # F, n_rows
            ctypes.c_void_p, ctypes.c_void_p,    # x, values
            ctypes.c_void_p,                     # ycol
            ctypes.POINTER(ctypes.c_void_p),     # bytes_out
            ctypes.POINTER(ctypes.c_int),        # bytes_width
            ctypes.c_void_p, ctypes.c_void_p,    # uniq_start, uniq_len
            ctypes.c_void_p, ctypes.c_int]       # n_uniq, max_uniq
        lib.csv_encode_mt.restype = ctypes.c_int
        lib.csv_encode_mt.argtypes = (list(lib.csv_encode.argtypes)
                                      + [ctypes.c_int])  # n_threads
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


def parse_csv_columns_buffer(buf: bytes, col_types, delim: str = ","
                             ) -> Optional[Tuple[int, Dict[int, np.ndarray]]]:
    """:func:`parse_csv_columns` over an in-memory buffer: the per-chunk
    form the shared scan uses to take only the columns a job reads, with
    no field matrix (BYTES columns come back as fixed-width ``S``
    arrays, FLOAT64 through C ``strtod``, the values ``float()`` gives)."""
    lib = get_lib()
    if len(delim) != 1:
        return None
    n_cols = len(col_types)
    bdelim = ctypes.c_char(delim.encode())
    widths = (ctypes.c_int * n_cols)(*([0] * n_cols))
    n_rows = lib.csv_scan(buf, len(buf), bdelim, n_cols, widths)
    if n_rows < 0:
        return None
    cols: Dict[int, np.ndarray] = {}
    outs = (ctypes.c_void_p * n_cols)(*([None] * n_cols))
    for j, t in enumerate(col_types):
        if t == INT64:
            a = np.empty(n_rows, dtype=np.int64)
        elif t == FLOAT64:
            a = np.empty(n_rows, dtype=np.float64)
        elif t == BYTES:
            a = np.empty(n_rows, dtype=f"S{max(int(widths[j]), 1)}")
        else:
            continue
        cols[j] = a
        outs[j] = a.ctypes.data
    rc = lib.csv_parse(buf, len(buf), bdelim, n_cols,
                       (ctypes.c_int * n_cols)(*col_types), widths, outs,
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
                         n_rows_hint: Optional[int] = None,
                         n_threads: Optional[int] = None):
    """Encode one in-memory buffer.  Each of ``col_specs`` is
    ``(file_ordinal, role, feat_idx, extra)``: ``role`` BUCKET (``extra``
    the bucket width), FLOATVAL or CAT, and ``feat_idx`` the destination
    feature column (Y_DEST for the class attribute).

    Returns ``(n_rows, x, values, y, ids, cat_uniques)``, where
    ``cat_uniques[ordinal]`` is the first-seen list of raw byte values of
    each categorical column (the codes in ``x``/``y`` index into it), or
    None when the input does not fit the fast path.  ``n_rows_hint`` (an
    exact line count) skips the csv_scan sizing pass when no id column
    needs its width metered.  ``n_threads`` forces the inner pthread
    fan-out (the parallel parse pool passes 1, so chunk-level and
    byte-range-level parallelism do not multiply); None keeps the
    size-based rule below."""
    lib = get_lib()
    if len(delim) != 1:
        return None
    bdelim = ctypes.c_char(delim.encode())

    col_type = [SKIP] * n_file_cols
    feat_idx = [-1] * n_file_cols
    bucket_w = [1] * n_file_cols
    for ordinal, role, fj, extra in col_specs:
        if ordinal >= n_file_cols:
            return None
        col_type[ordinal] = role
        feat_idx[ordinal] = fj
        if role == BUCKET:
            if extra <= 0:
                return None
            bucket_w[ordinal] = extra

    widths = (ctypes.c_int * n_file_cols)(*([0] * n_file_cols))
    if n_rows_hint is not None and id_ordinal < 0:
        n_rows = n_rows_hint        # widths only meter bytes (id) columns
    else:
        n_rows = lib.csv_scan(buf, len(buf), bdelim, n_file_cols, widths)
    if n_rows < 0:
        return None

    ids = None
    bytes_out = (ctypes.c_void_p * n_file_cols)(*([None] * n_file_cols))
    if id_ordinal >= 0:
        col_type[id_ordinal] = BYTES
        ids = np.empty(n_rows, dtype=f"S{max(int(widths[id_ordinal]), 1)}")
        bytes_out[id_ordinal] = ids.ctypes.data

    x = np.zeros((n_rows, n_feat), dtype=np.int32)
    values = np.zeros((n_rows, n_feat), dtype=np.float64)
    y = np.empty(n_rows, dtype=np.int32) if has_class else None
    cat_ordinals = [o for o, t, _, _ in col_specs if t == CAT]
    uniq_start = np.zeros((n_file_cols, max_uniq), dtype=np.int64) \
        if cat_ordinals else np.zeros((1, 1), dtype=np.int64)
    uniq_len = np.zeros_like(uniq_start, dtype=np.int32)
    n_uniq = np.zeros(n_file_cols, dtype=np.int32)

    # the multithreaded encode for large buffers; its per-thread
    # vocabulary scratch is n_cat * max_uniq * 16 B, so the large-vocab
    # retry stays single-threaded and the thread count shrinks with the
    # categorical column count to keep the scratch near 128 MB
    forced_threads = n_threads
    if n_threads is None:
        n_threads = 1
        if len(buf) >= MT_MIN_BYTES and max_uniq <= (1 << 16):
            n_threads = MT_THREADS or min(8, os.cpu_count() or 1)
            scratch_budget = 128 << 20
            per_thread = max(len(cat_ordinals), 1) * max_uniq * 16
            n_threads = max(min(n_threads, scratch_budget // per_thread), 1)
    else:
        n_threads = max(int(n_threads), 1)
    _count_call()
    rc = lib.csv_encode_mt(
        buf, len(buf), bdelim, n_file_cols,
        (ctypes.c_int * n_file_cols)(*col_type),
        (ctypes.c_int * n_file_cols)(*feat_idx),
        (ctypes.c_longlong * n_file_cols)(*bucket_w),
        n_feat, n_rows,
        x.ctypes.data, values.ctypes.data,
        y.ctypes.data if y is not None else None,
        bytes_out, widths,
        uniq_start.ctypes.data, uniq_len.ctypes.data, n_uniq.ctypes.data,
        uniq_start.shape[1], n_threads)
    if rc == -3 and max_uniq < (1 << 22):   # vocab overflow: one retry, 64x
        return encode_schema_buffer(buf, col_specs, n_file_cols, n_feat,
                                    has_class, id_ordinal, delim,
                                    max_uniq=1 << 22,
                                    n_threads=forced_threads)
    if rc != 0:
        return None

    cat_uniques: Dict[int, List[bytes]] = {}
    for o in cat_ordinals:
        k = int(n_uniq[o])
        cat_uniques[o] = [bytes(buf[int(s):int(s) + int(l)])
                          for s, l in zip(uniq_start[o, :k], uniq_len[o, :k])]
    return int(n_rows), x, values, y, ids, cat_uniques
