"""Chunked ingest: host chunks -> pinned staging -> non-blocking
host-to-device copy -> in-place count fold, on one device or over the
positions of a mesh.

The port's counterpart of ``avenir_tpu/core/pipeline.py``.  The input
streams through in row chunks; with ``pipeline.prefetch.depth`` d >= 1 a
worker thread encodes and copies up to d chunks ahead while the main
thread folds the previous one on the card, and depth 0 is the strict
serial reference (encode, copy, fold, synchronize, per chunk).  Device
memory holds a few chunks and the carry, never the dataset.

The fold keeps the reference's contract: every consumer exposes
``local_fn(*chunk_arrays, mask, *static_args)`` and the engine computes
``carry = sum over chunks of local_fn(chunk)``, so the count tables are
bit-identical to the one-shot pass (integer adds commute).  The reference
pads chunks to a fixed capacity so XLA compiles one shape; PyTorch runs
eagerly, so the port does not pad on one device, and ``mask`` is None
(every row valid).

The resilience hooks are the reference's: ``chunk_faults`` applies the
fault plan (core.faultinject) to each byte chunk, ``ChunkTransfer`` fires
the ``h2d`` point, a ``worker_death`` ends the prefetch worker without a
relay and the consumer's watchdog reports it, and items wrapped in
:class:`Checkpointed` make ``streaming_fold`` snapshot the carry and hand
it to a checkpointer one chunk later (:class:`AsyncCheckpointSaver`), so
the card does not wait on a checkpoint.  Spans (core.obs): ``ingest.h2d``
per transfer, ``ingest.fold`` per fold (the shared scan names its folds
``multiscan.fold``), ``checkpoint.save`` per save, and the
``ingest.prefetch.queue.depth`` gauge.

With a mesh of several positions (``streaming_fold(mesh=)``, built on
``ChunkTransfer(mesh=)`` and ``ChunkFold(mesh=)``) a chunk's rows pad to
the position count, every position folds its share with its validity
mask, and the shares are summed by the mesh's ``psum`` into the carry on
the mesh's first device.  Every chunked scan reads its input as raw byte
chunks through one reader, :func:`iter_byte_chunks_meta` (the read, the
cut at line ends, the resume offset and the fault points); the shared
scan (core.multiscan) folds each job's chunk through its own
:class:`ChunkFold`, whose carry may be one table or a dict of them.

Two pieces of the reference's module are not copied.  ``HostStager``
guards host buffers against XLA's zero-copy aliasing of a ``device_put``;
here :class:`ChunkTransfer` owns its pinned staging slots and reuses one
only after the CUDA event of its last copy, the same guarantee.
``clear_fold_cache`` empties the reference's memo of jitted fold pairs,
and the port compiles no fold, so it has no such memo.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import faultinject
from .obs import get_tracer

# config keys (the .properties surface; JobConfig prefix fallback applies)
KEY_CHUNK_ROWS = "pipeline.chunk.rows"
KEY_PREFETCH_DEPTH = "pipeline.prefetch.depth"
KEY_DEVICE_BUDGET = "pipeline.device.budget.bytes"

DEFAULT_CHUNK_ROWS = 1 << 16
DEFAULT_PREFETCH_DEPTH = 2


def chunk_rows_from_config(cfg, row_bytes: Optional[int] = None,
                           default: Optional[int] = None) -> Optional[int]:
    """The chunk row count: an explicit ``pipeline.chunk.rows`` wins; else
    a configured ``pipeline.device.budget.bytes`` (with the caller's row
    size estimate) derives it; else ``default``."""
    rows = cfg.get_int(KEY_CHUNK_ROWS, None)
    if rows is not None:
        if rows <= 0:
            raise ValueError(f"{KEY_CHUNK_ROWS} must be positive: {rows}")
        return rows
    budget = cfg.get_int(KEY_DEVICE_BUDGET, None)
    if budget is not None and row_bytes:
        return rows_for_budget(budget, row_bytes,
                               prefetch_depth_from_config(cfg))
    return default


def prefetch_depth_from_config(cfg) -> int:
    depth = cfg.get_int(KEY_PREFETCH_DEPTH, DEFAULT_PREFETCH_DEPTH)
    if depth < 0:
        raise ValueError(f"{KEY_PREFETCH_DEPTH} must be >= 0: {depth}")
    return depth


def rows_for_budget(budget_bytes: int, row_bytes: int,
                    prefetch_depth: int = DEFAULT_PREFETCH_DEPTH) -> int:
    """Chunk rows such that all chunks live at once fit the device budget:
    up to ``depth`` queued + 1 folding + 1 in transfer."""
    live = prefetch_depth + 2
    return max(int(budget_bytes) // (max(int(row_bytes), 1) * live), 1)


# ---------------------------------------------------------------------------
# host side: line and field chunk readers
# ---------------------------------------------------------------------------

def _open_text(fp: str):
    """One file-open attempt on the ingest path (a ``read`` fault point;
    runs under ``with_retries`` so transient failures back off)."""
    fi = faultinject.get_injector()
    if fi is not None:
        fi.fire("read")
    return open(fp, "r")


def iter_line_chunks(path: str, chunk_rows: int) -> Iterator[List[str]]:
    """Yield non-empty record lines in chunks of ``chunk_rows``: the
    row-chunked form of ``core.io.read_lines`` (same skip-blank contract),
    reading one buffered file at a time so memory is O(chunk).  Each
    chunk's file time is an ``ingest.read`` span."""
    from .io import _input_files
    from .resilience import with_retries

    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive: {chunk_rows}")
    tracer = get_tracer()
    buf: List[str] = []
    t0 = time.perf_counter_ns()
    for fp in _input_files(path):
        with with_retries(_open_text, fp, op="ingest.open") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line:
                    buf.append(line)
                    if len(buf) >= chunk_rows:
                        tracer.record_span("ingest.read", t0,
                                           time.perf_counter_ns() - t0,
                                           rows=len(buf))
                        yield buf
                        buf = []
                        # the clock restarts after the consumer resumes
                        # us: a read span times file I/O, not its work
                        t0 = time.perf_counter_ns()
    if buf:
        tracer.record_span("ingest.read", t0,
                           time.perf_counter_ns() - t0, rows=len(buf))
        yield buf


def iter_field_chunks(path: str, delim_regex: str,
                      chunk_rows: int) -> Iterator[object]:
    """Row chunks through ``split_field_lines`` (an ``ingest.parse`` span
    each): a 2-D string array for a rectangular chunk and a plain
    one-character delimiter, else per-line field lists."""
    tracer = get_tracer()
    for lines in iter_line_chunks(path, chunk_rows):
        t0 = time.perf_counter_ns()
        fields, bulk = split_field_lines(lines, delim_regex)
        tracer.record_span("ingest.parse", t0,
                           time.perf_counter_ns() - t0,
                           rows=len(lines), bulk=bulk)
        yield fields


# ---------------------------------------------------------------------------
# host side: chunk boundaries and field splitting
# ---------------------------------------------------------------------------

def row_chunk_ends(buf: bytes, chunk_rows: int) -> List[int]:
    """Byte offsets just past every ``chunk_rows``-th line end of ``buf``,
    plus the buffer end.  Blank lines count toward a chunk's line budget
    but not its parsed rows."""
    nl = np.flatnonzero(np.frombuffer(buf, dtype=np.uint8) == ord("\n"))
    ends = [int(e) for e in nl[chunk_rows - 1::chunk_rows] + 1]
    if not ends or ends[-1] < len(buf):
        ends.append(len(buf))
    return ends


def _byte_chunk_ends(buf: bytes, chunk_bytes: int) -> List[int]:
    """Byte offsets just past the first line end at or after each
    ``chunk_bytes`` step of ``buf``, plus the buffer end."""
    step = max(int(chunk_bytes), 1)
    ends, pos = [], 0
    while pos < len(buf):
        end = min(pos + step, len(buf))
        if end < len(buf):
            nl = buf.find(b"\n", end)
            end = len(buf) if nl < 0 else nl + 1
        ends.append(end)
        pos = end
    return ends


def iter_byte_chunks_meta(path: str, chunk_rows: Optional[int],
                          start_offset: int = 0,
                          chunk_bytes: int = 48 << 20
                          ) -> Iterator[Tuple[bytes, int, int]]:
    """``(chunk, chunk_index, end_offset)`` triples of the whole input,
    the one reader every chunked scan of the port cuts its chunks with
    (the chunked encode, its numpy reference, the shared scan, the
    bandit job).  The input is read once (host memory O(file), as the
    native ingest; device memory O(chunk)), an ``ingest.read`` span, and
    cut at line ends, an ``ingest.split`` span: past every
    ``chunk_rows``-th line end (:func:`row_chunk_ends`), or, where
    ``chunk_rows`` is None, past the first line end at or after each
    ``chunk_bytes`` step.  ``start_offset``, a checkpointed chunk-end
    offset, skips the chunks already folded: the boundaries derive from
    the whole buffer, so a resumed scan sees the chunking of an
    uninterrupted one.  Each chunk passes through :func:`chunk_faults`
    when it is taken."""
    from ..native import _read_buffer

    if chunk_rows is not None and chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive: {chunk_rows}")
    tracer = get_tracer()
    with tracer.span("ingest.read", path=path):
        buf = _read_buffer(path)
    if not buf:
        return
    with tracer.span("ingest.split", bytes=len(buf)):
        ends = (_byte_chunk_ends(buf, chunk_bytes) if chunk_rows is None
                else row_chunk_ends(buf, chunk_rows))
    pos = 0
    for idx, end in enumerate(ends):
        if end > start_offset:
            yield chunk_faults(buf[pos:end], idx), idx, end
        pos = end


def iter_byte_chunks(path: str, chunk_rows: int) -> Iterator[bytes]:
    """The raw byte chunks of :func:`iter_byte_chunks_meta`."""
    for chunk, _, _ in iter_byte_chunks_meta(path, chunk_rows):
        yield chunk


def first_nonblank_line(chunk: bytes) -> bytes:
    """The first non-empty line of a byte chunk (b"" if none), found
    without splitting the whole chunk."""
    pos = 0
    while pos < len(chunk):
        nl = chunk.find(b"\n", pos)
        if nl < 0:
            return chunk[pos:]
        if nl > pos:
            return chunk[pos:nl]
        pos = nl + 1
    return b""


def chunk_faults(chunk: bytes, index: int) -> bytes:
    """Apply the per-chunk fault plan to one byte chunk: ``slow``
    stalls, ``worker_death`` ends the producing thread without a relay,
    ``corrupt`` mangles the bytes.  The identity when no plan is
    configured."""
    fi = faultinject.get_injector()
    if fi is None:
        return chunk
    fi.fire("slow", index)
    fi.fire("worker_death", index)
    return fi.mangle("corrupt", index, chunk)


def split_field_lines(lines: List[str], delim_regex: str):
    """``(fields, bulk)`` for a chunk of non-blank lines: a 2-D string
    ndarray made with one whole-chunk split when the delimiter is one plain
    character and every line has the same field count (``bulk`` True),
    else per-line field lists."""
    from .io import is_plain_delim, split_line

    if is_plain_delim(delim_regex) and lines:
        n_delim = lines[0].count(delim_regex)
        if all(l.count(delim_regex) == n_delim for l in lines):
            flat = delim_regex.join(lines).split(delim_regex)
            return (np.asarray(flat, dtype=str).reshape(
                len(lines), n_delim + 1), True)
    return [split_line(l, delim_regex) for l in lines], False


def peek(it: Iterable):
    """(first item, iterator replaying it): lets callers size table
    extents from the first chunk before the fold starts.  Returns (None,
    empty iterator) for an empty stream."""
    it = iter(it)
    try:
        first = next(it)
    except StopIteration:
        return None, iter(())

    def chain():
        yield first
        yield from it

    return first, chain()


class _PrefetchError:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


_DONE = object()


def drive_prefetched(chunks: Iterable, produce: Callable, consume: Callable,
                     depth: int, tracer=None, parent=None, trace=None,
                     thread_name: str = "avenir-ingest-prefetch") -> None:
    """Run ``consume(produce(chunk))`` over a chunk stream: serially when
    ``depth <= 0``, else with ``produce`` (and the chunk generator's own
    work) on a worker thread feeding a queue of at most ``depth`` items.
    An exception on either side reaches the caller.  The consumer's
    bounded wait doubles as a liveness check, so a worker that dies
    without relaying its error (an injected ``worker_death``) is
    reported instead of blocking forever; on the way out the worker is
    told to stop and drained until it ends.  The worker's spans parent
    to ``parent`` (and join trace ``trace``); each of the consumer's
    waits for a chunk is an ``ingest.wait`` span."""
    tracer = tracer or get_tracer()
    if depth <= 0:
        for item in chunks:
            consume(produce(item))
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    worker_exc: list = [None]

    def worker():
        tracer.adopt(parent, trace)
        try:
            for item in chunks:
                if stop.is_set():
                    return
                q.put(produce(item))
                tracer.gauge("ingest.prefetch.queue.depth", q.qsize())
            q.put(_DONE)
        except faultinject.SimulatedWorkerDeath:
            # the injected hard death: end without relaying anything, as
            # if the relay itself had failed
            return
        except BaseException as exc:  # noqa: BLE001 — relayed to the caller
            worker_exc[0] = exc      # the side cell first: it cannot block
            q.put(_PrefetchError(exc))

    t = threading.Thread(target=worker, daemon=True, name=thread_name)
    t.start()
    try:
        while True:
            # the consumer's wait for its next chunk, an ``ingest.wait``
            # span (no clock read while the tracer is off)
            t_wait = time.perf_counter_ns() if tracer.enabled else 0
            while True:
                try:
                    item = q.get(timeout=0.1)
                    break
                except queue.Empty:
                    if not t.is_alive():
                        if worker_exc[0] is not None:
                            raise worker_exc[0]
                        raise RuntimeError("prefetch worker died without "
                                           "signaling an error")
            if item is _DONE:
                break
            if isinstance(item, _PrefetchError):
                raise item.exc
            if t_wait:
                tracer.record_span("ingest.wait", t_wait,
                                   time.perf_counter_ns() - t_wait)
            tracer.gauge("ingest.prefetch.queue.depth", q.qsize())
            consume(item)
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        t.join()


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a carry: a tensor or array, or a dict,
    tuple or list of carries (the reference's ``jax.tree_util.tree_map``
    over the carries the port's folds build)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a carry in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def add_into(carry, part):
    """``carry += part`` leaf by leaf, in place; returns ``carry``."""
    for c, p in zip(tree_leaves(carry), tree_leaves(part)):
        c += p
    return carry


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


class ChunkTransfer:
    """The host-to-device half of the fold: a chunk's host arrays become
    tensors on the device, followed by the chunk's validity mask (None:
    chunks are not padded, so every row is valid).

    On CUDA each array is copied into a pinned staging buffer and sent with
    ``non_blocking=True``, so the copy is queued on the current stream and
    the caller does not wait for it.  Staging buffers are reused, two per
    (position, shape, dtype) in turn.  A buffer must not be overwritten
    while the copy out of it may still be in flight, so each copy records a
    CUDA event and the buffer's next use waits on that event first (the
    reference guards its host staging the same way, in
    ``HostStager.committed``).  On the CPU the arrays are wrapped as they
    are.  One transfer object serves one producing thread.

    With a ``mesh`` of several positions the rows pad to a multiple of the
    position count (``parallel.mesh.pad_rows``) and are cut into one block
    per position (``shard_rows`` over ``('data', 'model')``): each array
    becomes a list of per-position tensors, and the mask a list of
    per-position bool tensors, False on the padding rows.

    Each call fires the ``h2d`` fault point first: a transfer failure is
    not retried (re-sending a half-sent buffer is not defined), so the
    job fails fast and leaves its checkpoint for ``--resume``."""

    SLOTS = 2

    def __init__(self, device: Optional[torch.device] = None, tracer=None,
                 mesh=None):
        if device is None and mesh is None:
            raise ValueError("pass a device or a mesh")
        self.mesh = mesh if _sharded(mesh) else None
        self.device = (device if device is not None
                       else mesh.devices.flat[0])
        self.tracer = tracer or get_tracer()
        self._staging: dict = {}
        self._turn: dict = {}

    def _slot(self, i: int, a: np.ndarray):
        key = (i, a.shape, a.dtype.str)
        ring = self._staging.get(key)
        if ring is None:
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            ring = [[torch.empty(a.shape, dtype=dtype, pin_memory=True),
                     torch.cuda.Event()] for _ in range(self.SLOTS)]
            self._staging[key] = ring
            self._turn[key] = 0
        i = self._turn[key]
        self._turn[key] = (i + 1) % self.SLOTS
        return ring[i]

    def __call__(self, arrs: Tuple[np.ndarray, ...]) -> tuple:
        fi = faultinject.get_injector()
        if fi is not None:
            fi.fire("h2d")
        with self.tracer.span("ingest.h2d"):
            arrs = tuple(np.ascontiguousarray(a) for a in arrs)
            n = arrs[0].shape[0]
            if any(a.shape[0] != n for a in arrs):
                raise ValueError("chunk arrays disagree on row count")
            if self.mesh is not None:
                return self._shard(arrs)
            if self.device.type != "cuda":
                # a read-only array (an mmapped cache chunk) is copied: a
                # tensor must not alias memory it may not write
                return tuple(torch.from_numpy(a if a.flags.writeable
                                              else a.copy())
                             for a in arrs) + (None,)
            out = []
            for i, a in enumerate(arrs):
                buf, event = self._slot(i, a)
                event.synchronize()     # the previous copy out of buf is done
                buf.numpy()[...] = a
                out.append(buf.to(self.device, non_blocking=True))
                event.record()
            return tuple(out) + (None,)

    def _shard(self, arrs) -> tuple:
        from ..parallel.mesh import pad_rows, shard_rows

        axes = ("data", "model")
        out, mask = [], None
        for a in arrs:
            pa, mask = pad_rows(a, self.mesh.size)
            out.append(shard_rows(pa if pa.flags.writeable else pa.copy(),
                                  self.mesh, axes))
        return tuple(out) + (shard_rows(mask, self.mesh, axes),)


class ChunkFold:
    """One stream's fold state.  The first chunk's ``local_fn`` result
    becomes the carry: a device tensor, or a dict (or tuple) of them.
    Every later chunk calls ``local_fn(..., out=carry)``, which adds into
    the carry in place.  (The reference donates the carry buffer to a
    jitted ``carry + psum(...)`` to get the same in-place accumulate.)
    ``broadcast`` are tensors passed to every call after the mask,
    before the static arguments, as the reference's ``broadcast_args``.

    With a ``mesh`` of several positions (chunks from
    ``ChunkTransfer(mesh=)``) each ``broadcast`` tensor is copied once to
    every device of the mesh (``parallel.mesh.replicate``), every position
    runs ``local_fn`` on its rows with its mask and its copies, the mesh's
    ``psum`` sums the tables onto the mesh's first device, and the sum is
    added into the carry there (``ops.counting.sharded_reduce_resident``).
    The carry lives on that device, so ``seed`` and ``snapshot`` work as
    on one device, and a snapshot holds the carry with the chunk's sum
    added.

    Each fold is a ``span_name`` span (``ingest.fold``; the shared scan
    names its ``multiscan.fold``) with ``span_attrs``."""

    def __init__(self, local_fn: Callable, static_args: tuple = (),
                 device: Optional[torch.device] = None, tracer=None,
                 parent=None, broadcast: Sequence[torch.Tensor] = (),
                 mesh=None, span_name: str = "ingest.fold",
                 span_attrs: Optional[dict] = None):
        self.local_fn = local_fn
        self.static_args = tuple(static_args)
        self.mesh = mesh if _sharded(mesh) else None
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = device
        self.broadcast = tuple(broadcast)
        if self.mesh is not None:
            from ..parallel.mesh import replicate
            self.broadcast = tuple(replicate(b, self.mesh)
                                   for b in self.broadcast)
        self.tracer = tracer or get_tracer()
        self.parent = parent
        self.span_name = span_name
        self.span_attrs = dict(span_attrs or {})
        self.carry = None
        self._host: Optional[list] = None

    def seed(self, carry_host) -> None:
        """Start from a host carry (a checkpointed one, or one the
        reference package computed): integer tables become int32 tensors
        on the fold's device, and later chunks accumulate on top of it, so
        a resumed stream continues where the checkpointed one stopped."""
        def place(a):
            a = np.asarray(a)
            if a.dtype.kind in "iu":
                a = a.astype(np.int32)
            return torch.tensor(a, device=self.device)
        self.carry = tree_map(place, carry_host)

    def snapshot(self):
        """A copy of the carry on its way to the host, or None before the
        first fold.  On CUDA each table goes into a pinned buffer with
        ``non_blocking=True`` and one event is recorded after them: the
        copies are queued after this fold and before the next one, which
        adds into the carry in place, so they hold exactly this state, and
        the caller does not wait for them.  :meth:`host_copy` waits for
        the event later.  One set of pinned buffers serves every snapshot:
        the saver materializes a snapshot before it takes the next."""
        if self.carry is None:
            return None
        leaves = tree_leaves(self.carry)
        if not leaves[0].is_cuda:
            return tree_map(torch.clone, self.carry), None
        if (self._host is None
                or [(h.shape, h.dtype) for h in self._host]
                != [(t.shape, t.dtype) for t in leaves]):
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in leaves]
        bufs = iter(self._host)

        def copy(t):
            h = next(bufs)
            h.copy_(t, non_blocking=True)
            return h
        snap = tree_map(copy, self.carry)
        event = torch.cuda.Event()
        event.record()
        return snap, event

    @staticmethod
    def host_copy(snap):
        """A snapshot as numpy arrays of its own, in the carry's shape."""
        t, event = snap
        if event is not None:
            event.synchronize()
        return tree_map(lambda h: h.numpy().copy(), t)

    def fold(self, dev: tuple) -> None:
        *arrays, mask = dev
        with self.tracer.span(self.span_name, parent=self.parent,
                              **self.span_attrs):
            if self.mesh is not None:
                from ..ops.counting import sharded_reduce_resident
                part = sharded_reduce_resident(
                    self.local_fn, *arrays, mask=mask, mesh=self.mesh,
                    static_args=self.static_args, broadcast=self.broadcast)
                if self.carry is None:
                    self.carry = part
                else:
                    add_into(self.carry, part)
            elif self.carry is None:
                self.carry = self.local_fn(*arrays, mask, *self.broadcast,
                                           *self.static_args)
            else:
                self.local_fn(*arrays, mask, *self.broadcast,
                              *self.static_args, out=self.carry)

    def block(self) -> None:
        if self.carry is None:
            return
        first = tree_leaves(self.carry)[0]
        if first.is_cuda:
            torch.cuda.synchronize(first.device)

    def result(self):
        """The carry as host numpy arrays in its shape (a table, or a dict
        of them), or None if nothing was folded."""
        if self.carry is None:
            return None
        return tree_map(lambda t: t.cpu().numpy(), self.carry)


class Checkpointed:
    """A chunk item carrying a checkpoint token (core.checkpoint): the
    producer wraps the chunk arrays it wants a checkpoint after, and
    ``streaming_fold`` snapshots the carry once that chunk's fold is
    queued and writes it one chunk later."""

    __slots__ = ("arrays", "token")

    def __init__(self, arrays: tuple, token):
        self.arrays = arrays
        self.token = token


class AsyncCheckpointSaver:
    """The deferred save of a checkpoint: ``push`` parks a (token,
    snapshot) pair, and ``flush``, called at every later consume and once
    after the stream ends, copies the snapshot to the host and writes the
    sidecar.  By then the next fold is queued, so the wait overlaps work
    on the card instead of draining the pipeline."""

    __slots__ = ("_ck", "_tracer", "_to_host", "_pending")

    def __init__(self, checkpointer, tracer, to_host: Callable):
        self._ck = checkpointer
        self._tracer = tracer
        self._to_host = to_host      # snapshot -> host numpy carry
        self._pending = None

    def push(self, token, snapshot) -> None:
        self.flush()                 # never hold more than one
        self._pending = (token, snapshot)

    def flush(self) -> None:
        if self._pending is None:
            return
        tok, snap = self._pending
        self._pending = None
        with self._tracer.span("checkpoint.save", chunk=tok.chunk_index):
            self._ck.save(tok, self._to_host(snap))


def streaming_fold(chunks: Iterable, local_fn: Callable,
                   static_args: tuple = (),
                   broadcast_args: Sequence[np.ndarray] = (),
                   device: Optional[torch.device] = None,
                   prefetch_depth: int = DEFAULT_PREFETCH_DEPTH,
                   checkpointer=None, initial_carry=None, mesh=None
                   ) -> Optional[np.ndarray]:
    """Fold row chunks into one count table on ``device``, or over
    ``mesh``.

    ``chunks`` yields tuples of host arrays sharing a leading row count;
    per-chunk host work (parsing, binning, moments, cap guards) belongs in
    the generator, which runs on the prefetch worker when
    ``prefetch_depth >= 1``.  Each chunk is copied to the device and
    folded with ``local_fn(*arrays, mask, *broadcast, *static_args)``,
    where ``broadcast`` are ``broadcast_args`` copied to the device once
    (the same for every chunk: a candidate index, a table).  Returns the
    table as a host numpy array, or None for an empty stream.  An
    exception in the generator reaches the caller whichever thread raised
    it.

    Items may be :class:`Checkpointed`: after folding such a chunk the
    carry is snapshotted and, one consume later, handed with the token to
    ``checkpointer.save``.  ``initial_carry`` (a host table from a loaded
    checkpoint) seeds the fold, so a resumed stream, empty when the kill
    came after the last chunk, continues from the checkpointed state.

    With a ``mesh`` of several positions (the reference's form) each
    chunk's rows pad to the position count and shard over every position
    (``ChunkTransfer(mesh=)``), the broadcast arguments are copied once to
    each device, and each chunk's tables are summed by the mesh's ``psum``
    into the carry on the mesh's first device (``ChunkFold(mesh=)``); the
    result equals the one-device fold's.  A mesh of one position folds on
    that position's device: the one-device path, with its pinned
    staging."""
    if mesh is not None:
        device = mesh.devices.flat[0]
        mesh = mesh if _sharded(mesh) else None
    tracer = get_tracer()
    parent = tracer.current_span_id()
    transfer = ChunkTransfer(device, tracer=tracer, mesh=mesh)
    broadcast = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in broadcast_args)
    cf = ChunkFold(local_fn, static_args=static_args, device=device,
                   tracer=tracer, parent=parent, broadcast=broadcast,
                   mesh=mesh)
    if initial_carry is not None:
        cf.seed(initial_carry)
    saver = (AsyncCheckpointSaver(checkpointer, tracer, ChunkFold.host_copy)
             if checkpointer is not None else None)

    def produce(item):
        if isinstance(item, Checkpointed):
            return transfer(item.arrays), item.token
        return transfer(item), None

    def consume(pair):
        dev, token = pair
        cf.fold(dev)
        if prefetch_depth <= 0:
            cf.block()
        if saver is not None:
            saver.flush()
            if token is not None:
                saver.push(token, cf.snapshot())

    drive_prefetched(chunks, produce, consume, prefetch_depth,
                     tracer=tracer, parent=parent)
    if saver is not None:
        saver.flush()
    return cf.result()
