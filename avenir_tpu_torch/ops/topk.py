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
``k3_supported`` / ``k3_applicable`` instead: K3's own limits and the
crossover with the sorted engine that ``chip_smoke.py`` measures.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch

K3_LAUNCHES = 0

_TB = 512               # the reference's candidate tile (gate threshold)
_MAX_K = 64
_MAX_F = 1024
_MAX_F_MANHATTAN = 64
_MAX_CAT = 16
_SEG = 1 << 18
_SENT = np.iinfo(np.int32).max

_fn = None


def reset_launch_counts() -> None:
    global K3_LAUNCHES
    K3_LAUNCHES = 0


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


# The crossover with the sorted engine, measured by chip_smoke.py on an
# H100 (F <= 256).  K3 parallelizes over query rows only (one block per 32)
# and stages the feature columns 32 at a time, so its time grows with
# nt * F per block, while the sorted engine's grows with nq * nt: K3 wins
# from about 12 query rows per staged column up.  Below 256 candidates
# the sorted engine's fixed cost of ~15 launches decides, and K3 wins.
K3_ROWS_PER_COLUMN = 12
K3_SHORT_NT = 256


def k3_applicable(algorithm: str, k: int, nq: int, nt: int, n_num: int,
                  n_cat: int, device: Union[str, torch.device, None] = None
                  ) -> bool:
    """The port's automatic engine choice: K3 on a CUDA device, within
    its own limits, where the measured crossover says it is the faster
    engine."""
    staged = -(-n_num // 32) * 32
    return (device is not None and torch.device(device).type == "cuda"
            and k3_supported(algorithm, k, n_num, n_cat)
            and (nt <= K3_SHORT_NT or nq >= K3_ROWS_PER_COLUMN * staged))


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
# wrapper
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


def _kernel():
    global _fn
    if _fn is None:
        from . import _build
        lib = _build.load("topk")
        fn = lib.avenir_topk
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, ci, vp, vp, vp, ci, ci, ci, cf, cf, ci, ci,
                       vp, vp, vp]
        fn.restype = ci
        lib.avenir_topk_error_string.argtypes = [ci]
        lib.avenir_topk_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def fused_pairwise_topk(qnum: torch.Tensor, qcat: torch.Tensor,
                        tnum: torch.Tensor, tcat: torch.Tensor,
                        cat_weights: torch.Tensor, wsum: float, scale: int,
                        k: int, algorithm: str = "euclidean"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: the exact per-query k smallest ``(dist, idx)`` with the
    reference's conventions: numeric columns float32 and already
    weight-folded (sqrt(w) premultiplied for euclidean), categorical
    columns int32 codes with per-column float32 ``cat_weights``, ``wsum``
    the summed weights, int distances scaled by ``scale``.  Returns
    ``(dist int32 [nq, k], idx int32 [nq, k], suspect bool [nq])``;
    ``suspect`` is all false (see the module docstring)."""
    global K3_LAUNCHES
    _check(qnum, qcat, tnum, tcat, cat_weights, k, algorithm)
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
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qnum.data_ptr(), tnum.data_ptr(), qnum.shape[1],
                 qcat.data_ptr(), tcat.data_ptr(), cat_weights.data_ptr(),
                 qcat.shape[1], nq, nt, float(np.float32(wsum)),
                 float(np.float32(scale)), k,
                 int(algorithm == "euclidean"), vals.data_ptr(),
                 idxs.data_ptr(), stream)
    if err != 0:
        from . import _build
        msg = _build.load("topk").avenir_topk_error_string(err)
        raise RuntimeError(f"topk kernel launch failed: CUDA error {err} "
                           f"({msg.decode()})")
    K3_LAUNCHES += 1
    return vals, idxs, suspect
