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
(``merge_topk_lists``, counted in ``MERGE_LAUNCHES``) merges them.  The
plain versions of that path are ``plain_split_pairwise_topk`` and
``plain_merge_topk``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple, Union

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
                         n_cat: int, scale: int) -> bool:
    """The reference's hard constraints on the fused engine
    (pallas_topk.py:119): k <= 64, at least one column, at most 1024
    numeric columns (64 for manhattan) and 16 categorical ones, and its
    int32 packing budget over a candidate segment of up to 2^18 rows."""
    nt_pad = -(-max(nt, 1) // _TB) * _TB
    val_budget = 1 << (31 - _seg_bits(min(nt_pad, _SEG)))
    max_f = {"euclidean": _MAX_F, "manhattan": _MAX_F_MANHATTAN}
    return (algorithm in max_f
            and 0 < k <= _MAX_K
            and n_num + n_cat > 0
            and n_num <= max_f[algorithm]
            and n_cat <= _MAX_CAT
            and scale * 8 <= val_budget)


def fused_topk_applicable(algorithm: str, k: int, nt: int, n_num: int,
                          n_cat: int, scale: int,
                          device: Union[str, torch.device, None] = None
                          ) -> bool:
    """The auto-selection gate (pallas_topk.py:145): the hard constraints,
    a candidate axis of at least 2,048 rows, and a CUDA device."""
    return (device is not None and torch.device(device).type == "cuda"
            and nt >= 4 * _TB
            and fused_topk_supported(algorithm, k, nt, n_num, n_cat, scale))


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


def plain_merge_topk(keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel's function in plain PyTorch: ``keys`` [S, nq, k]
    int64, each [s, row] the sorted unique keys ``(value << 32) | index``
    of one segment (``INT64_MAX`` in empty slots); returns the k smallest
    of each row as ``(dist int32 [nq, k], idx int32 [nq, k])``,
    ``INT32_MAX`` / ``-1`` in empty slots."""
    S, nq, k = keys.shape
    flat = keys.permute(1, 0, 2).reshape(nq, S * k)
    best = torch.topk(flat, k, dim=1, largest=False, sorted=True).values
    empty = best == _SENT64
    vals = torch.where(empty, _SENT, best >> 32).to(torch.int32)
    idxs = torch.where(empty, -1, best & 0xFFFFFFFF).to(torch.int32)
    return vals, idxs


def plain_segment_keys(qnum: torch.Tensor, qcat: torch.Tensor,
                       tnum: torch.Tensor, tcat: torch.Tensor,
                       cat_weights: torch.Tensor, wsum: float, scale: int,
                       k: int, bounds: list, algorithm: str = "euclidean"
                       ) -> torch.Tensor:
    """The sorted k-list of each candidate segment ``[lo, hi)`` of
    ``bounds`` (``plain_pairwise_topk`` on the segment) as int64 keys with
    global indices, ``[S, nq, k]``: the merge kernel's input."""
    keys = torch.full((len(bounds), qnum.shape[0], k), _SENT64,
                      dtype=torch.int64, device=qnum.device)
    for s, (lo, hi) in enumerate(bounds):
        v, i, _ = plain_pairwise_topk(qnum, qcat, tnum[lo:hi], tcat[lo:hi],
                                      cat_weights, wsum, scale, k, algorithm)
        keys[s] = torch.where(i >= 0, (v.long() << 32) | (i.long() + lo),
                              _SENT64)
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
                                    vp, vp, vp, vp, vp]
        lib.avenir_topk.restype = ci
        lib.avenir_topk_merge.argtypes = [vp, ci, ci, ci, vp, vp, vp]
        lib.avenir_topk_merge.restype = ci
        lib.avenir_topk_error_string.argtypes = [ci]
        lib.avenir_topk_error_string.restype = ctypes.c_char_p
        _lib_topk = lib
    return _lib_topk


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().avenir_topk_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def merge_topk_lists(keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel of K3's split path (``csrc/topk.cu``
    ``merge_kernel``): ``plain_merge_topk``'s function.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.  Each
    launch adds one to ``MERGE_LAUNCHES``."""
    if keys.dtype != torch.int64 or keys.dim() != 3 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous int64 [S, nq, k] tensor")
    S, nq, k = keys.shape
    if not 1 <= k <= _MAX_K or S < 1:
        raise ValueError(f"need S >= 1 and k in [1, {_MAX_K}]")
    if keys.device.type == "cpu":
        return plain_merge_topk(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    vals = torch.empty((nq, k), dtype=torch.int32, device=keys.device)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=keys.device)
    if nq:
        lib = _lib()
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            _raise_on(lib.avenir_topk_merge(keys.data_ptr(), S, nq, k,
                                            vals.data_ptr(), idxs.data_ptr(),
                                            stream), "topk merge kernel")
        _count_launch("MERGE_LAUNCHES")
    return vals, idxs


def fused_pairwise_topk(qnum: torch.Tensor, qcat: torch.Tensor,
                        tnum: torch.Tensor, tcat: torch.Tensor,
                        cat_weights: torch.Tensor, wsum: float, scale: int,
                        k: int, algorithm: str = "euclidean",
                        split: Optional[int] = None
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
    them."""
    _check(qnum, qcat, tnum, tcat, cat_weights, k, algorithm)
    if qnum.device.type == "cpu":
        return plain_pairwise_topk(qnum, qcat, tnum, tcat, cat_weights,
                                   wsum, scale, k, algorithm)
    nq, nt, F = qnum.shape[0], tnum.shape[0], qnum.shape[1]
    dev = qnum.device
    vals = torch.empty((nq, k), dtype=torch.int32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    suspect = torch.zeros(nq, dtype=torch.bool, device=dev)
    if nq == 0:
        return vals, idxs, suspect
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bm, splits, per = k3_plan(nq, nt, sms, split)
    fpad = -(-F // 16) * 16        # whole stages of csrc/topk.cu FK
    ldq, ldt = -(-nq // bm) * bm, -(-nt // _BN) * _BN

    def scratch(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    qT, q2 = scratch(fpad, ldq), scratch(ldq)
    tT, t2 = scratch(fpad, ldt), scratch(ldt)
    seg = gkth = None
    if splits > 1:
        seg = scratch(splits, nq, k, dtype=torch.int64)
        gkth = torch.full((nq,), _SENT, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.avenir_topk(
            qnum.data_ptr(), tnum.data_ptr(), F, qcat.data_ptr(),
            tcat.data_ptr(), cat_weights.data_ptr(), qcat.shape[1], nq, nt,
            float(np.float32(wsum)), float(np.float32(scale)), k,
            int(algorithm == "euclidean"), bm, splits, per, qT.data_ptr(),
            tT.data_ptr(), q2.data_ptr(), t2.data_ptr(),
            None if seg is None else seg.data_ptr(),
            None if gkth is None else gkth.data_ptr(), vals.data_ptr(),
            idxs.data_ptr(), stream), "topk kernel")
    _count_launch("K3_LAUNCHES")
    if seg is not None:
        vals, idxs = merge_topk_lists(seg)
    return vals, idxs, suspect
