"""Fused distance + exact k-smallest selection: the wrapper of kernel K3
(``csrc/topk.cu``) and its plain PyTorch version.

Counterpart of ``avenir_tpu/ops/pallas_topk.py``.  K3 replaces the Pallas
kernel ``_make_kernel`` (pallas_topk.py:226, entered through
``fused_pairwise_topk`` :489).  Its contract is ``select_and_check``'s
(:373-399): per query row the k smallest ``(value, index)`` pairs in
ascending lexicographic order (lowest candidate index first on ties),
``INT32_MAX`` / ``-1`` in empty slots, and a ``suspect`` flag for every
row whose selection could be wrong.  The Pallas kernel keeps 128 bins of
4 packed registers per row and must flag rows whose bins overflowed; K3
keeps an exact sorted list of unique int64 keys per row, so no row can
come out wrong and ``suspect`` is always false.  The flag stays in the
API, and ``ops.distance.pairwise_distances`` still re-resolves flagged
rows through the sorted engine; on the card that branch runs only once
a kernel that can flag rows exists.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches K3 or raises.  Each launch adds one to ``K3_LAUNCHES``.

Two pairs of gates.  ``fused_topk_supported`` / ``fused_topk_applicable``
give the reference's answers (its int32 packing budget, its 2^18-row
segments, its 2,048-row tile threshold), except that "a TPU backend"
becomes "a CUDA device"; ``topk_method='fused'`` is held to them, so both
packages accept and refuse the same forced configurations.  K3 has none
of those limits, so the automatic engine choice on the card asks
``k3_supported`` / ``k3_applicable`` instead: K3's own limits (it is the
faster engine at every shape ``chip_smoke.py`` measures).

On the card K3 may cut the candidate axis into segments (``k3_plan``);
each segment's sorted k-list goes to a scratch tensor and the merge kernel
K3m (``merge_topk_lists``, counted in ``MERGE_LAUNCHES``) merges them, on
the launch plan ``merge_plan`` computes per shape: how many warps merge a
row, how many rows a block holds, and how its lists are staged in shared
memory.  The
plain versions of that path are ``plain_split_pairwise_topk`` and
``plain_merge_topk``.

The multi-device engines use two more forms of the same kernels:
``segment_keys`` (K3 writing its segments' lists as keys whose indices
start at an index base: a ring hop's or a model shard's first global
row) and ``merge_topk_keys`` (the merge kernel leaving keys and each
row's k-th value, the carry of ``ops.distance.pairwise_topk_ring``).
``fused_pairwise_topk(..., mesh=)`` shards the query rows over the mesh's
``data`` axis and the candidate rows over ``model``, and merges the model
shards' lists with one merge launch per data shard: the reference's
``_build_fused`` (pallas_topk.py:412-484), whose ``all_gather`` and
two-key sort ``_lex_merge`` that merge replaces.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

K3_LAUNCHES = 0
MERGE_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_TB = 512               # the reference's candidate tile (gate threshold)
_MAX_K = 64
_MAX_F = 1024
_MAX_F_MANHATTAN = 64
_MAX_CAT = 16
_SEG = 1 << 18
_SENT = np.iinfo(np.int32).max
_SENT64 = np.iinfo(np.int64).max

_lib_topk = None


def reset_launch_counts() -> None:
    global K3_LAUNCHES, MERGE_LAUNCHES
    with _COUNT_LOCK:
        K3_LAUNCHES = MERGE_LAUNCHES = 0


def _count_launch(name: str) -> None:
    """Add one to the launch counter ``name`` under a lock: two serving
    replicas' batcher threads can launch at once, and an unlocked ``+=``
    on a module global can lose a count."""
    with _COUNT_LOCK:
        globals()[name] += 1


def _seg_bits(extent: int) -> int:
    return max(int(np.ceil(np.log2(max(extent, 2)))), 1)


def fused_topk_supported(algorithm: str, k: int, nt: int, n_num: int,
                         n_cat: int, scale: int, m_ax: int = 1) -> bool:
    """The reference's hard constraints on the fused engine
    (pallas_topk.py:119): k <= 64, at least one column, at most 1024
    numeric columns (64 for manhattan) and 16 categorical ones, and its
    int32 packing budget over a candidate segment of up to 2^18 rows of
    one of ``m_ax`` model shards."""
    step = m_ax * _TB
    nt_pad = -(-max(nt, 1) // step) * step
    val_budget = 1 << (31 - _seg_bits(min(nt_pad // m_ax, _SEG)))
    max_f = {"euclidean": _MAX_F, "manhattan": _MAX_F_MANHATTAN}
    return (algorithm in max_f
            and 0 < k <= _MAX_K
            and n_num + n_cat > 0
            and n_num <= max_f[algorithm]
            and n_cat <= _MAX_CAT
            and scale * 8 <= val_budget)


def fused_topk_applicable(algorithm: str, k: int, nt: int, n_num: int,
                          n_cat: int, scale: int,
                          device: Union[str, torch.device, None] = None,
                          m_ax: int = 1) -> bool:
    """The auto-selection gate (pallas_topk.py:145): the hard constraints,
    a candidate axis of at least 2,048 rows, and a CUDA device."""
    return (device is not None and torch.device(device).type == "cuda"
            and nt >= 4 * _TB
            and fused_topk_supported(algorithm, k, nt, n_num, n_cat, scale,
                                     m_ax=m_ax))


def k3_supported(algorithm: str, k: int, n_num: int, n_cat: int) -> bool:
    """K3's own limits (``csrc/topk.cu``): k <= 64, at most 16
    categorical columns, at least one column.  It loops over the feature
    columns and the candidate axis and keeps int64 keys, so it has no
    feature cap, no row cap and no packing budget."""
    return (algorithm in ("euclidean", "manhattan") and 0 < k <= _MAX_K
            and n_cat <= _MAX_CAT and n_num + n_cat > 0)


def k3_applicable(algorithm: str, k: int, n_num: int, n_cat: int,
                  device: Union[str, torch.device, None] = None) -> bool:
    """The port's automatic engine choice: K3 on a CUDA device, within its
    own limits.  ``chip_smoke.py`` measures K3 against the sorted engine
    over a grid of query and candidate counts (64 to 16,384 by 256 to
    65,536 at F = 256) and at every other K3 shape it holds: K3 is the
    faster engine at every point, so no shape goes to the sorted engine
    (PERF.md, the K3 engine crossover)."""
    return (device is not None and torch.device(device).type == "cuda"
            and k3_supported(algorithm, k, n_num, n_cat))


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the on-card comparison)
# ---------------------------------------------------------------------------

_BLOCK_ELEMS = 1 << 24      # query rows per block: ~this many pairs


def plain_pairwise_topk(qnum: torch.Tensor, qcat: torch.Tensor,
                        tnum: torch.Tensor, tcat: torch.Tensor,
                        cat_weights: torch.Tensor, wsum: float, scale: int,
                        k: int, algorithm: str = "euclidean"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: the distance block of
    ``ops.distance._block_dist`` for a block of query rows at a time, then
    the exact ``topk_smallest``.  Returns ``(dist int32 [nq, k], idx int32
    [nq, k], suspect bool [nq])``."""
    from .distance import _block_dist, topk_smallest

    nq, nt = qnum.shape[0], tnum.shape[0]
    dev = qnum.device
    kk = min(k, nt)
    vals = torch.full((nq, k), _SENT, dtype=torch.int32, device=dev)
    idxs = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    step = max(_BLOCK_ELEMS // max(nt, 1), 1)
    for lo in range(0, nq if kk else 0, step):
        hi = min(lo + step, nq)
        d = _block_dist(qnum[lo:hi], qcat[lo:hi], tnum, tcat, cat_weights,
                        wsum, algorithm, scale)
        v, i = topk_smallest(d, kk)
        vals[lo:hi, :kk] = v
        idxs[lo:hi, :kk] = i
    return vals, idxs, torch.zeros(nq, dtype=torch.bool, device=dev)


# ---------------------------------------------------------------------------
# the split candidate axis: plan, plain split and plain merge
# ---------------------------------------------------------------------------

_BN = 128           # K3's candidate tile (csrc/topk.cu BN)


def k3_plan(nq: int, nt: int, sms: int, split: Optional[int] = None
            ) -> Tuple[int, int, int]:
    """K3's launch shape ``(bm, splits, tiles_per_seg)``.  ``bm``, the
    query rows of a block, is 64 where 128-row tiles would pad the query
    axis by more than a quarter, else 128; an SM holds one 128-row block
    or two 64-row ones (registers).  ``splits`` cuts the 128-row candidate
    tiles into segments of ``tiles_per_seg``: where the query tiles alone
    give fewer than two blocks per SM (``sms``), the grid (query tiles x
    segments) takes two to four blocks per SM: the fewest segments that
    minimize the waves of resident blocks per unit of work.
    ``split`` forces the number of segments.  No segment is empty."""
    bm = 64 if -(-nq // 128) * 128 > 1.25 * nq else 128
    qtiles = max(-(-nq // bm), 1)
    ntiles = -(-nt // _BN)

    def cut(want):
        per = -(-ntiles // max(1, min(want, ntiles))) if ntiles else 0
        return (-(-ntiles // per) if per else 1), per

    if split is not None:
        return (bm,) + cut(split)
    if qtiles >= 2 * sms:
        return (bm,) + cut(1)
    slots = sms * (128 // bm)
    least = -(-2 * sms // qtiles)

    def waves_per_work(plan):
        return -(-qtiles * plan[0] // slots) / plan[0]

    plans = sorted({cut(s) for s in range(least, 2 * least + 1)})
    return (bm,) + min(plans, key=lambda plan: (waves_per_work(plan),
                                                plan[0]))


def segment_bounds(nt: int, splits: int, tiles_per_seg: int) -> list:
    """The candidate rows ``[lo, hi)`` of each of K3's segments."""
    step = tiles_per_seg * _BN
    return [(min(s * step, nt), min((s + 1) * step, nt))
            for s in range(splits)]


def device_plan(nq: int, nt: int, device: torch.device
                ) -> Tuple[int, int, int]:
    """``k3_plan`` for ``nq`` x ``nt`` on ``device``'s SM count; on the CPU
    one segment (the plain version's answer does not depend on the
    segments)."""
    if device.type != "cuda":
        return k3_plan(nq, nt, 1, split=1)
    return k3_plan(nq, nt, torch.cuda.get_device_properties(
        device).multi_processor_count)


# ---------------------------------------------------------------------------
# the merge's launch plan (pure; held by the CPU tests)
# ---------------------------------------------------------------------------

_MERGE_BLOCK_WARPS = 4      # a block's warps where it holds several rows
_MERGE_FILL_WARPS = 32      # warps an SM is given where rows are few


class MergePlan(NamedTuple):
    warps: int      # warps that merge one row (a power of two, <= 32)
    rows: int       # consecutive rows a block owns
    slots: int      # lists of a row in shared memory at once
    rounds: int     # staging rounds (the first fills every slot, each
                    # later one slots 1.. behind the running list)
    smem: int       # dynamic shared bytes a block: slots x rows x k keys
    grid: int       # blocks: ceil(nq / rows), at least one


def merge_plan(S: int, nq: int, k: int, sms: int, smem_per_block: int
               ) -> MergePlan:
    """How ``csrc/topk.cu``'s ``merge_kernel`` (K3m) merges ``S`` sorted
    lists of ``k`` keys for each of ``nq`` rows on a card with ``sms`` SMs
    and ``smem_per_block`` shared bytes a block may opt into.

    A row's tree of pairwise merges has ``S // 2`` pairs at its first
    level, and a warp step merges ``max(1, 32 // 2k)`` of them.  A row gets
    as many warps as that level has steps (a power of two, at most 32),
    but no more than it takes to give every SM ``_MERGE_FILL_WARPS`` warps
    over all the rows: many lists and few rows (a serving batch) spread a
    row over a whole block, many rows (the kNN job) give a row one warp.
    A block holds ``_MERGE_BLOCK_WARPS`` warps' worth of rows, fewer where
    that would leave SMs without a block or where the rows' lists do not
    fit its shared memory (a block that holds one row for that reason
    gets that row the warps it had).  Every list of a row is staged at
    once where they fit one block; else in rounds of ``slots - 1`` lists
    behind the running list.  Raises where not even two lists fit."""
    if S < 1 or nq < 0 or not 1 <= k <= _MAX_K or sms < 1:
        raise ValueError(f"no merge plan for S={S} nq={nq} k={k} on "
                         f"{sms} SMs")
    list_bytes = 8 * k
    steps = -(-(S // 2) // max(1, 32 // (2 * k)))
    useful = min(32, 1 << max(steps - 1, 0).bit_length())
    fill = max(1, sms * _MERGE_FILL_WARPS // max(nq, 1))
    warps = min(useful, 1 << (fill.bit_length() - 1))
    want = max(1, min(_MERGE_BLOCK_WARPS // warps, -(-nq // sms)))
    rows = max(1, min(want, smem_per_block // (S * list_bytes)))
    if rows < want:
        warps = min(useful, warps * want // rows)
    slots = min(S, smem_per_block // (rows * list_bytes))
    if slots < min(S, 2):
        raise ValueError(f"two lists of {k} keys do not fit "
                         f"{smem_per_block} shared bytes")
    rounds = 1 if slots >= S else 1 + -(-(S - slots) // (slots - 1))
    return MergePlan(warps, rows, slots, rounds, rows * slots * list_bytes,
                     max(1, -(-nq // rows)))


def plain_merge_topk_keys(keys: torch.Tensor) -> torch.Tensor:
    """The keys-out merge in plain PyTorch: the k smallest keys of each
    row of ``keys`` [S, nq, k] (sorted unique int64 keys ``(value << 32) |
    index`` per list, ``INT64_MAX`` in empty slots), sorted, ``[nq, k]``."""
    S, nq, k = keys.shape
    flat = keys.permute(1, 0, 2).reshape(nq, S * k)
    return torch.topk(flat, k, dim=1, largest=False, sorted=True).values


def split_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted keys as ``(dist int32, idx int32)``, ``INT32_MAX`` / ``-1``
    in empty slots."""
    empty = keys == _SENT64
    vals = torch.where(empty, _SENT, keys >> 32).to(torch.int32)
    idxs = torch.where(empty, -1, keys & 0xFFFFFFFF).to(torch.int32)
    return vals, idxs


def plain_merge_topk(keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel's function in plain PyTorch: ``keys`` [S, nq, k]
    int64, each [s, row] the sorted unique keys ``(value << 32) | index``
    of one segment (``INT64_MAX`` in empty slots); returns the k smallest
    of each row as ``(dist int32 [nq, k], idx int32 [nq, k])``,
    ``INT32_MAX`` / ``-1`` in empty slots."""
    return split_keys(plain_merge_topk_keys(keys))


def plain_segment_keys(qnum: torch.Tensor, qcat: torch.Tensor,
                       tnum: torch.Tensor, tcat: torch.Tensor,
                       cat_weights: torch.Tensor, wsum: float, scale: int,
                       k: int, bounds: list, algorithm: str = "euclidean",
                       base: int = 0) -> torch.Tensor:
    """The sorted k-list of each candidate segment ``[lo, hi)`` of
    ``bounds`` (``plain_pairwise_topk`` on the segment) as int64 keys with
    indices ``base + row``, ``[S, nq, k]``: the merge kernel's input."""
    keys = torch.full((len(bounds), qnum.shape[0], k), _SENT64,
                      dtype=torch.int64, device=qnum.device)
    for s, (lo, hi) in enumerate(bounds):
        v, i, _ = plain_pairwise_topk(qnum, qcat, tnum[lo:hi], tcat[lo:hi],
                                      cat_weights, wsum, scale, k, algorithm)
        keys[s] = torch.where(
            i >= 0, (v.long() << 32) | (i.long() + lo + base), _SENT64)
    return keys


def plain_split_pairwise_topk(qnum: torch.Tensor, qcat: torch.Tensor,
                              tnum: torch.Tensor, tcat: torch.Tensor,
                              cat_weights: torch.Tensor, wsum: float,
                              scale: int, k: int, bounds: list,
                              algorithm: str = "euclidean"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's split path in plain PyTorch: ``plain_segment_keys`` then
    ``plain_merge_topk``.  Equal to the unsplit plain version, since the
    keys are unique."""
    return plain_merge_topk(plain_segment_keys(
        qnum, qcat, tnum, tcat, cat_weights, wsum, scale, k, bounds,
        algorithm))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(qnum, qcat, tnum, tcat, cat_weights, k, algorithm) -> None:
    dev = qnum.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if algorithm not in ("euclidean", "manhattan"):
        raise ValueError(f"unsupported distance algorithm {algorithm!r}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k must be in [1, {_MAX_K}], got {k}")
    for name, t, dtype in (("qnum", qnum, torch.float32),
                           ("tnum", tnum, torch.float32),
                           ("qcat", qcat, torch.int32),
                           ("tcat", tcat, torch.int32),
                           ("cat_weights", cat_weights, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qnum on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nq, nt = qnum.shape[0], tnum.shape[0]
    F, C = qnum.shape[1], qcat.shape[1]
    if (tnum.shape[1] != F or tcat.shape[1] != C or qcat.shape[0] != nq
            or tcat.shape[0] != nt or cat_weights.shape != (C,)):
        raise ValueError("operand shapes disagree: qnum [nq, F], tnum "
                         "[nt, F], qcat [nq, C], tcat [nt, C], "
                         "cat_weights [C]")
    if C > _MAX_CAT:
        raise ValueError(f"at most {_MAX_CAT} categorical columns, got {C}")
    if F + C == 0:
        raise ValueError("no columns to compare")
    if max(nq, nt) >= 2 ** 31:
        raise ValueError("row counts must be below 2^31")


def _lib():
    global _lib_topk
    if _lib_topk is None:
        from . import _build
        lib = _build.load("topk")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.avenir_topk.argtypes = [vp, vp, ci, vp, vp, vp, ci, ci, ci, cf,
                                    cf, ci, ci, ci, ci, ci, vp, vp, vp, vp,
                                    vp, vp, vp, vp, ci, vp]
        lib.avenir_topk.restype = ci
        lib.avenir_topk_merge.argtypes = [vp, vp, vp, vp, vp, vp, vp]
        lib.avenir_topk_merge.restype = ci
        lib.avenir_topk_device.argtypes = [ci, ctypes.POINTER(ci),
                                           ctypes.POINTER(ci)]
        lib.avenir_topk_device.restype = ci
        lib.avenir_topk_merge_prepare.argtypes = [ci]
        lib.avenir_topk_merge_prepare.restype = ci
        lib.avenir_topk_error_string.argtypes = [ci]
        lib.avenir_topk_error_string.restype = ctypes.c_char_p
        _lib_topk = lib
    return _lib_topk


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().avenir_topk_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_keys(keys: torch.Tensor) -> int:
    """Raises on keys the merge does not take; else their CUDA device
    index, or -1 on the CPU (indices, not ``torch.device`` objects: the
    merge's call time at a serving batch is mostly the host's)."""
    if keys.dtype != torch.int64 or keys.dim() != 3 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous int64 [S, nq, k] tensor")
    S, _, k = keys.shape
    if not 1 <= k <= _MAX_K or S < 1:
        raise ValueError(f"need S >= 1 and k in [1, {_MAX_K}]")
    if not (keys.is_cuda or keys.is_cpu):
        raise ValueError(f"unsupported device {keys.device}")
    return keys.get_device()


class _MergePlan(ctypes.Structure):
    """A launch's shape and its ``MergePlan`` as csrc/topk.cu's
    ``MergePlan``."""
    _fields_ = [(name, ctypes.c_int32)
                for name in ("S", "nq", "k") + MergePlan._fields]


@functools.lru_cache(maxsize=None)
def _merge_device(device: int) -> Tuple[int, int]:
    """``(sms, smem_per_block)`` of a card, read once; and the merge
    kernel allowed that card's whole opt-in shared memory."""
    lib = _lib()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib.avenir_topk_device(device, ctypes.byref(sms),
                                     ctypes.byref(smem)), "device query")
    with torch.cuda.device(device):
        _raise_on(lib.avenir_topk_merge_prepare(smem.value),
                  "topk merge shared-memory opt-in")
    return sms.value, smem.value


@functools.lru_cache(maxsize=1024)
def _merge_launch_plan(device: int, S: int, nq: int, k: int) -> tuple:
    """The merge plan of one launch shape as the kernel reads it, and the
    address the kernel reads it at."""
    st = _MergePlan(S, nq, k, *merge_plan(S, nq, k, *_merge_device(device)))
    return st, ctypes.addressof(st)


def _merge_launch(keys, device, vals=None, idxs=None, out=None,
                  kth=None) -> None:
    S, nq, k = keys.shape
    if not nq:
        return
    # the struct stays referenced here until the launch has read it
    plan, addr = _merge_launch_plan(device, S, nq, k)
    args = (keys.data_ptr(), addr, _ptr(vals), _ptr(idxs), _ptr(out),
            _ptr(kth))
    # the current stream as a plain integer, as torch's own generated code
    # reads it: no torch.cuda.Stream object is built per call
    if device == torch._C._cuda_getDevice():
        err = _lib().avenir_topk_merge(
            *args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = _lib().avenir_topk_merge(
                *args, torch._C._cuda_getCurrentRawStream(device))
    _raise_on(err, "topk merge kernel")
    _count_launch("MERGE_LAUNCHES")


def merge_topk_lists(keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel of K3's split path (``csrc/topk.cu``
    ``merge_kernel``, launched on ``merge_plan``'s plan):
    ``plain_merge_topk``'s function.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.  Each launch adds one to
    ``MERGE_LAUNCHES``."""
    device = _check_keys(keys)
    if device < 0:
        return plain_merge_topk(keys)
    S, nq, k = keys.shape
    # one allocation for both outputs
    vals, idxs = torch.empty((2, nq, k), dtype=torch.int32,
                             device=keys.device).unbind()
    _merge_launch(keys, device, vals=vals, idxs=idxs)
    return vals, idxs


def merge_topk_keys(keys: torch.Tensor, out: torch.Tensor,
                    kth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The merge kernel's keys-out form: the k smallest keys of each row
    of ``keys`` [S, nq, k], sorted, written to ``out`` [nq, k] int64
    (which may be ``keys[0]``: the merge reads a row's lists before it
    writes the row), and each row's k-th value (``INT32_MAX`` where the row
    holds fewer than k keys) to ``kth`` [nq] int32 when given.  Returns
    ``out``.  CPU tensors take the plain version (``plain_merge_topk_keys``);
    CUDA tensors launch the kernel or raise, adding one to
    ``MERGE_LAUNCHES``."""
    device = _check_keys(keys)
    S, nq, k = keys.shape
    for name, t, dtype, shape in (("out", out, torch.int64, (nq, k)),
                                  ("kth", kth, torch.int32, (nq,))):
        if t is None:
            continue
        if (t.dtype != dtype or t.shape != shape
                or not t.is_contiguous() or t.get_device() != device):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {keys.device}")
    if device < 0:
        best = plain_merge_topk_keys(keys)
        out.copy_(best)
        if kth is not None:
            kth.copy_((best[:, k - 1] >> 32).to(torch.int32))
        return out
    _merge_launch(keys, device, out=out, kth=kth)
    return out


def _k3_launch(qnum, qcat, tnum, tcat, cat_weights, wsum, scale, k,
               algorithm, bm, splits, per, seg=None, gkth=None, vals=None,
               idxs=None, base=0) -> None:
    """One K3 call on the card: the layout scratch, then ``avenir_topk``
    writing ``seg`` (keys) or ``vals`` / ``idxs``."""
    nq, nt, F = qnum.shape[0], tnum.shape[0], qnum.shape[1]
    dev = qnum.device
    fpad = -(-F // 16) * 16        # whole stages of csrc/topk.cu FK
    ldq, ldt = -(-nq // bm) * bm, -(-nt // _BN) * _BN

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    qT, q2 = scratch(fpad, ldq), scratch(ldq)
    tT, t2 = scratch(fpad, ldt), scratch(ldt)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.avenir_topk(
            qnum.data_ptr(), tnum.data_ptr(), F, qcat.data_ptr(),
            tcat.data_ptr(), cat_weights.data_ptr(), qcat.shape[1], nq, nt,
            float(np.float32(wsum)), float(np.float32(scale)), k,
            int(algorithm == "euclidean"), bm, splits, per, qT.data_ptr(),
            tT.data_ptr(), q2.data_ptr(), t2.data_ptr(), _ptr(seg),
            _ptr(gkth), _ptr(vals), _ptr(idxs), base, stream),
            "topk kernel")
    _count_launch("K3_LAUNCHES")


def segment_keys(qnum: torch.Tensor, qcat: torch.Tensor,
                 tnum: torch.Tensor, tcat: torch.Tensor,
                 cat_weights: torch.Tensor, wsum: float, scale: int, k: int,
                 algorithm: str = "euclidean", base: int = 0,
                 out: Optional[torch.Tensor] = None,
                 kth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's keys-out form: the sorted k keys ``(value << 32) | (base +
    row)`` of each segment of ``device_plan``'s plan, ``[S, nq, k]`` int64
    (``INT64_MAX`` in empty slots), written to ``out`` when given: the
    input of ``merge_topk_lists`` / ``merge_topk_keys``.  ``base`` is the
    global index of the first candidate row (a ring hop's owner block, a
    model shard).  ``kth`` [nq] int32, on the card, holds a k-th value per
    row that is at least the row's final k-th value over every list the
    caller will merge (a ring carry's): K3 then keeps out of the lists any
    pair above it, and tightens it in place; the merged answer is the same.
    CPU tensors take the plain version (``plain_segment_keys`` over one
    segment, ``kth`` unused); CUDA tensors launch K3 or raise."""
    _check(qnum, qcat, tnum, tcat, cat_weights, k, algorithm)
    nq, nt = qnum.shape[0], tnum.shape[0]
    dev = qnum.device
    if base < 0 or base + nt >= 2 ** 31:
        raise ValueError(f"index base {base} + {nt} rows must stay in "
                         f"[0, 2^31)")
    bm, splits, per = device_plan(nq, nt, dev)
    if out is None:
        out = torch.empty((splits, nq, k), dtype=torch.int64, device=dev)
    elif (out.dtype != torch.int64 or tuple(out.shape) != (splits, nq, k)
          or not out.is_contiguous() or out.device != dev):
        raise ValueError(f"out must be a contiguous int64 {(splits, nq, k)} "
                         f"tensor on {dev}")
    if kth is not None and (kth.dtype != torch.int32
                            or tuple(kth.shape) != (nq,)
                            or kth.device != dev):
        raise ValueError(f"kth must be an int32 ({nq},) tensor on {dev}")
    if dev.type == "cpu":
        out.copy_(plain_segment_keys(qnum, qcat, tnum, tcat, cat_weights,
                                     wsum, scale, k,
                                     segment_bounds(nt, splits, per),
                                     algorithm, base))
        return out
    if nq == 0:
        return out
    if splits > 1 and kth is None:
        kth = torch.full((nq,), _SENT, dtype=torch.int32, device=dev)
    _k3_launch(qnum, qcat, tnum, tcat, cat_weights, wsum, scale, k,
               algorithm, bm, splits, per, seg=out, gkth=kth, base=base)
    return out


def fused_pairwise_topk(qnum: torch.Tensor, qcat: torch.Tensor,
                        tnum: torch.Tensor, tcat: torch.Tensor,
                        cat_weights: torch.Tensor, wsum: float, scale: int,
                        k: int, algorithm: str = "euclidean",
                        split: Optional[int] = None, mesh=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: the exact per-query k smallest ``(dist, idx)`` with the
    reference's conventions: numeric columns float32 and already
    weight-folded (sqrt(w) premultiplied for euclidean), categorical
    columns int32 codes with per-column float32 ``cat_weights``, ``wsum``
    the summed weights, int distances scaled by ``scale``.  Returns
    ``(dist int32 [nq, k], idx int32 [nq, k], suspect bool [nq])``;
    ``suspect`` is all false (see the module docstring).  On the card the
    candidate axis is cut into ``k3_plan``'s segments (``split`` forces
    their number) and, with more than one, ``merge_topk_lists`` merges
    them.

    With ``mesh`` (``parallel.mesh.Mesh``) the query rows shard over its
    ``data`` axis and the candidate rows over ``model``, the operands
    moving to each position's device; the answer, on the mesh's first
    device, is the one-device answer, ties included.  With one model
    shard each data shard is a one-device call; with more, each model
    shard's K3 writes its lists as keys with its global index base
    (``segment_keys``) and one merge launch per data shard merges them."""
    _check(qnum, qcat, tnum, tcat, cat_weights, k, algorithm)
    if mesh is not None:
        if split is not None:
            raise ValueError("split applies to the one-device call")
        return _fused_on_mesh(qnum, qcat, tnum, tcat, cat_weights, wsum,
                              scale, k, algorithm, mesh)
    if qnum.device.type == "cpu":
        return plain_pairwise_topk(qnum, qcat, tnum, tcat, cat_weights,
                                   wsum, scale, k, algorithm)
    nq, nt = qnum.shape[0], tnum.shape[0]
    dev = qnum.device
    vals = torch.empty((nq, k), dtype=torch.int32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    suspect = torch.zeros(nq, dtype=torch.bool, device=dev)
    if nq == 0:
        return vals, idxs, suspect
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bm, splits, per = k3_plan(nq, nt, sms, split)
    seg = gkth = None
    if splits > 1:
        seg = torch.empty((splits, nq, k), dtype=torch.int64, device=dev)
        gkth = torch.full((nq,), _SENT, dtype=torch.int32, device=dev)
    _k3_launch(qnum, qcat, tnum, tcat, cat_weights, wsum, scale, k,
               algorithm, bm, splits, per, seg=seg, gkth=gkth, vals=vals,
               idxs=idxs)
    if seg is not None:
        vals, idxs = merge_topk_lists(seg)
    return vals, idxs, suspect


def _fused_on_mesh(qnum, qcat, tnum, tcat, cat_weights, wsum, scale, k,
                   algorithm, mesh):
    """``fused_pairwise_topk`` on a ``(data, model)`` mesh: the reference's
    ``_build_fused`` (pallas_topk.py:412-484), one controller driving every
    position in turn."""
    from ..parallel.mesh import gather, shard_grid, to_device

    d_ax, m_ax = mesh.shape["data"], mesh.shape["model"]
    t_loc = -(-tnum.shape[0] // m_ax)
    home = mesh.devices[0, 0]
    Q, QC = shard_grid(qnum, mesh, "data"), shard_grid(qcat, mesh, "data")
    model_axis = "model" if m_ax > 1 else None
    T, TC = shard_grid(tnum, mesh, model_axis), shard_grid(tcat, mesh,
                                                           model_axis)
    W = shard_grid(cat_weights, mesh)
    vals: List[torch.Tensor] = []
    idxs: List[torch.Tensor] = []
    for i in range(d_ax):
        if m_ax == 1:
            v, ix, _ = fused_pairwise_topk(Q[i][0], QC[i][0], T[i][0],
                                           TC[i][0], W[i][0], wsum, scale, k,
                                           algorithm)
        else:
            # each model shard's lists, with its global index base; the
            # merge of all of them is exact with the global lowest-index
            # tie order, as the reference's two-key sort is
            lists = [segment_keys(Q[i][j], QC[i][j], T[i][j], TC[i][j],
                                  W[i][j], wsum, scale, k, algorithm,
                                  base=j * t_loc)
                     for j in range(m_ax)]
            v, ix = merge_topk_lists(gather(lists, mesh.devices[i, 0]))
        vals.append(to_device(v, home))
        idxs.append(to_device(ix, home))
    return (torch.cat(vals), torch.cat(idxs),
            torch.zeros(qnum.shape[0], dtype=torch.bool, device=home))
