"""Class x feature x bin histograms: wrappers of the CUDA kernel in
``csrc/histogram.cu`` and their plain PyTorch versions.

Counterpart of ``avenir_tpu/ops/pallas_count.py``:

- K1, ``wide_feature_class_counts``, replaces the Pallas kernel
  ``_make_kernel(widths=None)`` (pallas_count.py:53, entered at :134);
- K2, ``wide_feature_class_counts_rawbin``, replaces the same body with
  static bucket widths (entered at :145), which bins inside the count.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel, or raises: there is no fallback for a CUDA tensor.
Each launch adds one to the module's count for that kernel
(``K1_LAUNCHES``/``K2_LAUNCHES``), so a run can show that its main path
went through the kernels.  The kernel has no row cap and no table cap:
``histogram_plan`` puts the table in one block's shared memory, a
thread-block cluster's or global memory by its size.

A call on the card does no host work beyond its argument checks and the
launch: the plan, the card's attributes, the kernels' shared-memory limit
and K2's per-width constants (``k2_constants``, copied to the card once
per widths tuple and device) are all cached.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from .counting import bin_raw, count_table

K1_LAUNCHES = 0
K2_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_CODE_DTYPES = (torch.int8, torch.int32)
_INT32_MAX = 2 ** 31 - 1

# csrc/histogram.cu's launch shape: kThreads, and the kMinBlocksPerSM of
# its __launch_bounds__ (64 registers a thread), which caps residency.
# Both size the grid only; the launch checks the plan's layout itself.
THREADS = 256
BLOCKS_PER_SM = 4
# codes a block counts per tile, by the width of a code in bytes: 32 (int8)
# or 16 (int32) a thread; the grid is at most one tile a block.  The launch
# refuses a plan whose tile is not the kernel's.
TILE_ELEMS = {1: 8192, 4: 4096}
# Blocks a cluster takes.  Every count into another block's slice crosses
# the SM-to-SM network: on the H100 a table in 4 or 8 slices counted slower
# than global atomics (PERF.md; ``python -m avenir_tpu_torch.histogram_probe
# --routes``), so the plan tries only a pair.
CLUSTER = 2
SMEM_RESERVED = 1024                  # shared bytes the card keeps per block
ROUTES = ("block table", "cluster", "global")


def reset_launch_counts() -> None:
    global K1_LAUNCHES, K2_LAUNCHES
    with _COUNT_LOCK:
        K1_LAUNCHES = 0
        K2_LAUNCHES = 0


def _count_launch(name: str) -> None:
    """Add one to the launch counter ``name`` under a lock: two serving
    replicas' batcher threads can launch at once, and an unlocked ``+=``
    on a module global can lose a count."""
    with _COUNT_LOCK:
        globals()[name] += 1


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the on-card comparison)
# ---------------------------------------------------------------------------

def plain_feature_class_counts(x: torch.Tensor, y: torch.Tensor,
                               n_class: int, max_bins: int,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """K1's function as a scatter (``count_table``) over the
    (class, feature, bin) key of every element of ``x``."""
    n, F = x.shape
    col = torch.arange(F, device=x.device)[None, :].expand(n, F)
    ycol = y[:, None].expand(n, F)
    m = None if mask is None else mask[:, None].expand(n, F)
    return count_table((n_class, F, max_bins), (ycol, col, x), mask=m)


def plain_feature_class_counts_rawbin(xraw: torch.Tensor, y: torch.Tensor,
                                      n_class: int, max_bins: int,
                                      widths: Sequence[int],
                                      mask: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """K2's function: ``bin_raw`` then K1's plain version."""
    return plain_feature_class_counts(bin_raw(xraw, widths), y, n_class,
                                      max_bins, mask=mask)


# ---------------------------------------------------------------------------
# the launch plan and K2's constants (pure; held by the CPU tests)
# ---------------------------------------------------------------------------

class HistogramPlan(NamedTuple):
    route: int          # index into ROUTES
    grid: int           # blocks, a whole number of clusters
    cluster: int        # blocks per cluster (1 off the cluster route)
    slice: int          # cells each block of a cluster holds (0 otherwise)
    tile: int           # codes a block counts per tile
    stage: int          # shared byte offset of the tile's staged row offsets
    table: int          # shared byte offset of the table, slice or nothing
    smem: int           # dynamic shared bytes a block


def histogram_plan(n: int, F: int, C: int, B: int, x_bytes: int, sms: int,
                   smem_per_block: int, smem_per_sm: int,
                   rawbin: bool = False, route: Optional[int] = None,
                   cluster: int = CLUSTER) -> HistogramPlan:
    """Where the ``C*F*B`` table lives and how many blocks count the
    ``n*F`` codes of ``x_bytes`` each, on a card with ``sms`` SMs,
    ``smem_per_block`` bytes of shared memory a block may opt into and
    ``smem_per_sm`` an SM has.

    A block's shared memory is, in order: K2's ``(w, m)`` pairs
    (``rawbin``), the row offsets of one tile (``stage``), then from
    ``table`` on the table, by size: one copy per block and a trash cell
    while it fits; else a slice of it in each block of a ``cluster``
    (route 1); else nothing, the counts going to global memory (route 2).
    ``route`` forces one route, which must fit.  The grid is every
    resident block, or one block a whole tile when there are fewer tiles;
    never empty.  Raises where even the fixed part does not fit a
    block."""
    cells = C * F * B
    tile = TILE_ELEMS[x_bytes]
    stage = -(-8 * F // 16) * 16 if rawbin else 0
    table = stage + 16 * -(-(tile // F + 3) // 4)
    room = (smem_per_block - table) // 4         # cells a block can hold
    if room < 1:
        raise ValueError(f"{F} features do not fit the histogram kernel's "
                         f"shared memory ({smem_per_block} bytes a block)")
    if route is None:
        route = 0 if cells + 1 <= room else 1 if cells <= room * cluster \
            else 2
    if route != 1:
        cluster = 1
    slice_ = -(-cells // cluster) if route == 1 else 0
    smem = table + 4 * (cells + 1 if route == 0 else slice_)
    if smem > smem_per_block or route == 1 and not 2 <= cluster <= 8:
        raise ValueError(f"a {cells}-cell table does not fit route "
                         f"{ROUTES[route]!r} with {cluster} blocks")
    resident = max(1, min(BLOCKS_PER_SM,
                          smem_per_sm // (smem + SMEM_RESERVED)))
    want = min(sms * resident, n * F // tile)
    grid = max(cluster, want // cluster * cluster)
    return HistogramPlan(route, grid, cluster, slice_, tile, stage, table,
                         smem)


@functools.lru_cache(maxsize=None)
def k2_constants(widths: tuple) -> tuple:
    """``(w, m)`` per bucket width, ``m = floor((2^32 - 1) / w)``: K2
    takes ``q = umulhi(|x|, m)``, adds one where ``|x| - q*w >= w`` and
    puts the sign back, which is ``trunc(x / w)`` for every int32 ``x``.
    Raises unless every width is in ``[1, 2^31 - 1]``."""
    ws = tuple(int(w) for w in widths)
    if any(not 1 <= w <= _INT32_MAX for w in ws):
        raise ValueError(f"bucket widths must be in [1, 2^31 - 1]: {ws}")
    return tuple((w, 0xFFFFFFFF // w) for w in ws)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(x, y, mask, n_class: int, max_bins: int, out) -> int:
    """Raises on a bad argument; else ``x``'s CUDA device index, or -1 on
    the CPU.  Devices are compared by index: a ``torch.device`` per
    tensor would cost more than the launch."""
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("x must be a 2-D tensor [n, F]")
    n, F = x.shape
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"unsupported device {x.device}")
    dev = x.get_device()
    if x.dtype not in _CODE_DTYPES:
        raise TypeError(f"x must be int8 or int32, got {x.dtype}")
    if not isinstance(y, torch.Tensor) or y.shape != (n,):
        raise ValueError(f"y must be a tensor of shape ({n},)")
    if y.dtype not in _CODE_DTYPES:
        raise TypeError(f"y must be int8 or int32, got {y.dtype}")
    if mask is not None:
        if not isinstance(mask, torch.Tensor) or mask.shape != (n,):
            raise ValueError(f"mask must be a tensor of shape ({n},)")
        if mask.dtype != torch.bool:
            raise TypeError(f"mask must be bool, got {mask.dtype}")
    if n_class < 1 or max_bins < 1:
        raise ValueError("n_class and max_bins must be >= 1")
    if n_class * F * max_bins >= 2 ** 31:
        raise ValueError("count table has 2^31 cells or more")
    if out is not None:
        if out.dtype != torch.int32 or out.shape != (n_class, F, max_bins):
            raise ValueError(f"out must be int32 [{n_class}, {F}, "
                             f"{max_bins}]")
    for name, t in (("x", x), ("y", y), ("mask", mask), ("out", out)):
        if t is None:
            continue
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


class _Plan(ctypes.Structure):
    """A launch's shape and its ``HistogramPlan`` as csrc/histogram.cu's
    ``Plan``."""
    _fields_ = [("n", ctypes.c_int64)] + [(name, ctypes.c_int32) for name in (
        "F", "C", "B", "x_bytes") + HistogramPlan._fields] + [
        ("slice_m", ctypes.c_uint32)]


def plan_struct(n: int, F: int, C: int, B: int, x_bytes: int,
                plan: HistogramPlan) -> _Plan:
    """The struct the launch reads: the shape, the plan and the cluster
    route's reciprocal of its slice."""
    return _Plan(n, F, C, B, x_bytes, *plan,
                 0xFFFFFFFF // plan.slice if plan.slice else 0)


_lib = None
_wm_tables = {}      # (widths, device index) -> K2's (w, m) pairs on the card


def _library():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("histogram")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        pi = ctypes.POINTER(ci)
        lib.avenir_histogram.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp]
        lib.avenir_histogram.restype = ci
        lib.avenir_histogram_device.argtypes = [ci, pi, pi, pi]
        lib.avenir_histogram_device.restype = ci
        lib.avenir_histogram_prepare.argtypes = [ci]
        lib.avenir_histogram_prepare.restype = ci
        lib.avenir_cuda_error_string.argtypes = [ci]
        lib.avenir_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _library().avenir_cuda_error_string(err).decode()
        raise RuntimeError(f"histogram kernel {what} failed: CUDA error "
                           f"{err} ({msg})")


@functools.lru_cache(maxsize=None)
def _device_info(device: int) -> tuple:
    """``(sms, smem_per_block, smem_per_sm)`` of a card, read once; and
    every kernel allowed that card's whole opt-in shared memory."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(3)]
    _raise_on(lib.avenir_histogram_device(device, *map(ctypes.byref, vals)),
              "attribute query")
    info = tuple(v.value for v in vals)
    with torch.cuda.device(device):
        _raise_on(lib.avenir_histogram_prepare(info[1]),
                  "shared-memory opt-in")
    return info


@functools.lru_cache(maxsize=1024)
def _launch_plan(device: int, x_bytes: int, rawbin: bool, n: int, F: int,
                 C: int, B: int) -> tuple:
    """The plan of one launch shape as the kernel reads it, and the
    address the kernel reads it at."""
    st = plan_struct(n, F, C, B, x_bytes, histogram_plan(
        n, F, C, B, x_bytes, *_device_info(device), rawbin=rawbin))
    return st, ctypes.addressof(st)


def _wm_table(widths: tuple, device: int) -> torch.Tensor:
    """K2's ``k2_constants`` as int32 pairs on the card, copied once."""
    key = (widths, device)
    t = _wm_tables.get(key)
    if t is None:
        flat = [v - (1 << 32) if v > _INT32_MAX else v
                for pair in k2_constants(widths) for v in pair]
        t = torch.tensor(flat, dtype=torch.int32,
                         device=torch.device("cuda", device))
        _wm_tables[key] = t
    return t


def _launch(x, y, mask, wm, out, device: int) -> bool:
    """Launch the kernel on the current stream of card ``device``; False
    if there was no work (no rows or no features), so no launch to
    count."""
    n, F = x.shape
    if n == 0 or F == 0:
        return False
    C, _, B = out.shape
    # the struct stays referenced here until the launch has read it
    plan, addr = _launch_plan(device, x.element_size(), wm is not None, n, F,
                              C, B)
    lib = _library()
    args = (x.data_ptr(), y.data_ptr(), y.element_size(),
            None if mask is None else mask.data_ptr(),
            None if wm is None else wm.data_ptr(), out.data_ptr(), addr)
    # the current stream as a plain integer, as torch's own generated code
    # reads it: no torch.cuda.Stream object is built per call
    if device == torch._C._cuda_getDevice():
        err = lib.avenir_histogram(
            *args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = lib.avenir_histogram(
                *args, torch._C._cuda_getCurrentRawStream(device))
    _raise_on(err, "launch")
    return True


def wide_feature_class_counts(x: torch.Tensor, y: torch.Tensor,
                              n_class: int, max_bins: int,
                              mask: Optional[torch.Tensor] = None,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """K1: ``C[class, feature, bin] += 1`` per (row, feature), int32
    ``[n_class, F, max_bins]``.  ``x`` int8/int32 ``[n, F]`` with any
    out-of-range code (e.g. -1) adding nothing, ``y`` int8/int32 ``[n]``
    (out-of-range classes add nothing), ``mask`` bool ``[n]`` dropping
    rows.  With ``out`` (int32, on the same device) the counts are added
    into it in place; otherwise a zeroed table is returned."""
    device = _check(x, y, mask, n_class, max_bins, out)
    if device < 0:
        counts = plain_feature_class_counts(x, y, n_class, max_bins, mask)
        return counts if out is None else out.add_(counts)
    if out is None:
        out = torch.zeros((n_class, x.shape[1], max_bins), dtype=torch.int32,
                          device=x.device)
    if _launch(x, y, mask, None, out, device):
        _count_launch("K1_LAUNCHES")
    return out


def wide_feature_class_counts_rawbin(xraw: torch.Tensor, y: torch.Tensor,
                                     n_class: int, max_bins: int,
                                     widths: Sequence[int],
                                     mask: Optional[torch.Tensor] = None,
                                     out: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """K2: K1 over ``bin_raw(xraw, widths)``, with the binning done inside
    the kernel.  ``widths`` are the per-feature bucket divisors, each in
    ``[1, 2^31 - 1]`` (1 = passthrough); division truncates toward
    zero."""
    widths = tuple(widths)
    k2_constants(widths)                 # validates; cached per tuple
    device = _check(xraw, y, mask, n_class, max_bins, out)
    if len(widths) != xraw.shape[1]:
        raise ValueError(f"widths has {len(widths)} entries for "
                         f"{xraw.shape[1]} features")
    if device < 0:
        counts = plain_feature_class_counts_rawbin(xraw, y, n_class, max_bins,
                                                   widths, mask)
        return counts if out is None else out.add_(counts)
    if out is None:
        out = torch.zeros((n_class, xraw.shape[1], max_bins),
                          dtype=torch.int32, device=xraw.device)
    if _launch(xraw, y, mask, _wm_table(widths, device), out, device):
        _count_launch("K2_LAUNCHES")
    return out
