"""Chunked ingest on one device: host chunks -> pinned staging ->
non-blocking host-to-device copy -> in-place count fold.

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
eagerly, so the port does not pad, and ``mask`` is None (every row
valid).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

# config keys (the .properties surface; JobConfig prefix fallback applies)
KEY_CHUNK_ROWS = "pipeline.chunk.rows"
KEY_PREFETCH_DEPTH = "pipeline.prefetch.depth"
KEY_DEVICE_BUDGET = "pipeline.device.budget.bytes"

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
                     depth: int) -> None:
    """Run ``consume(produce(chunk))`` over a chunk stream: serially when
    ``depth <= 0``, else with ``produce`` (and the chunk generator's own
    work) on a worker thread feeding a queue of at most ``depth`` items.
    An exception on either side reaches the caller.  The consumer's
    bounded wait doubles as a liveness check, so a worker that dies
    without relaying its error is reported instead of blocking forever;
    on the way out the worker is told to stop and drained until it ends."""
    if depth <= 0:
        for item in chunks:
            consume(produce(item))
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    worker_exc: list = [None]

    def worker():
        try:
            for item in chunks:
                if stop.is_set():
                    return
                q.put(produce(item))
            q.put(_DONE)
        except BaseException as exc:  # noqa: BLE001 — relayed to the caller
            worker_exc[0] = exc      # the side cell first: it cannot block
            q.put(_PrefetchError(exc))

    t = threading.Thread(target=worker, daemon=True,
                         name="avenir-ingest-prefetch")
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=0.1)
            except queue.Empty:
                if not t.is_alive():
                    if worker_exc[0] is not None:
                        raise worker_exc[0]
                    raise RuntimeError("prefetch worker died without "
                                       "signaling an error")
                continue
            if item is _DONE:
                break
            if isinstance(item, _PrefetchError):
                raise item.exc
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
    are.  One transfer object serves one producing thread."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
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
        arrs = tuple(np.ascontiguousarray(a) for a in arrs)
        n = arrs[0].shape[0]
        if any(a.shape[0] != n for a in arrs):
            raise ValueError("chunk arrays disagree on row count")
        if self.device.type != "cuda":
            # a read-only array (an mmapped cache chunk) is copied: a
            # tensor must not alias memory it may not write
            return tuple(torch.from_numpy(a if a.flags.writeable
                                          else a.copy())
                         for a in arrs) + (None,)
        out = []
        for i, a in enumerate(arrs):
            buf, event = self._slot(i, a)
            event.synchronize()       # the previous copy out of buf is done
            buf.numpy()[...] = a
            out.append(buf.to(self.device, non_blocking=True))
            event.record()
        return tuple(out) + (None,)


class ChunkFold:
    """One stream's fold state.  The first chunk's ``local_fn`` result
    becomes the carry, a device int32 tensor; every later chunk calls
    ``local_fn(..., out=carry)``, whose kernel adds into the carry in
    place.  (The reference donates the carry buffer to a jitted
    ``carry + psum(...)`` to get the same in-place accumulate.)"""

    def __init__(self, local_fn: Callable, static_args: tuple = (),
                 device: Optional[torch.device] = None):
        self.local_fn = local_fn
        self.static_args = tuple(static_args)
        self.device = device
        self.carry: Optional[torch.Tensor] = None

    def seed(self, carry_host: np.ndarray) -> None:
        """Start from a host count table (e.g. one the reference package
        computed): later chunks accumulate on top of it."""
        from ..convert import count_table_to_device
        self.carry = count_table_to_device(carry_host, self.device)

    def fold(self, dev: tuple) -> None:
        *arrays, mask = dev
        if self.carry is None:
            self.carry = self.local_fn(*arrays, mask, *self.static_args)
        else:
            self.local_fn(*arrays, mask, *self.static_args, out=self.carry)

    def block(self) -> None:
        if self.carry is not None and self.carry.is_cuda:
            torch.cuda.synchronize(self.carry.device)

    def result(self) -> Optional[np.ndarray]:
        """The carry as a host numpy array (None if nothing was folded)."""
        return None if self.carry is None else self.carry.cpu().numpy()


def streaming_fold(chunks: Iterable[Tuple[np.ndarray, ...]],
                   local_fn: Callable, static_args: tuple = (),
                   device: Optional[torch.device] = None,
                   prefetch_depth: int = DEFAULT_PREFETCH_DEPTH
                   ) -> Optional[np.ndarray]:
    """Fold row chunks into one count table on ``device``.

    ``chunks`` yields tuples of host arrays sharing a leading row count;
    per-chunk host work (parsing, binning, moments, cap guards) belongs in
    the generator, which runs on the prefetch worker when
    ``prefetch_depth >= 1``.  Each chunk is copied to the device and
    folded with ``local_fn(*arrays, mask, *static_args)``.  Returns the
    table as a host numpy array, or None for an empty stream.  An
    exception in the generator reaches the caller whichever thread raised
    it."""
    transfer = ChunkTransfer(device)
    cf = ChunkFold(local_fn, static_args=static_args, device=device)

    def consume(dev):
        cf.fold(dev)
        if prefetch_depth <= 0:
            cf.block()

    drive_prefetched(chunks, transfer, consume, prefetch_depth)
    return cf.result()
