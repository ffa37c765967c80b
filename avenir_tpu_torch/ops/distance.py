"""Pairwise distances and exact top-k on one device: the engine behind the
kNN distance job.

Counterpart of ``avenir_tpu/ops/distance.py``.  Per-attribute distances
(numeric columns range-normalized by the caller, categorical columns 0/1
mismatch), weight-averaged over the attributes and scaled to int by
``distance.scale``.  Two exact engines, as in the reference:

- the fused engine, kernel K3 (``ops.topk.fused_pairwise_topk``), which
  never materializes the ``[nq, nt]`` block; taken automatically on a
  CUDA device within K3's own limits where the measured crossover says it
  is faster (``ops.topk.k3_applicable``);
- the sorted engine: ``_block_dist`` on a block of query rows (the
  euclidean cross term is one ``torch.matmul``, which the reference left
  to XLA outside Pallas), then ``topk_smallest``.

The two engines compute the cross term in different orders, so a distance
that lands on an int-scale rounding boundary may differ by one unit
between them (the reference's own contract, ``distance.py:454-458``).
Float32 matrix products here run without TF32: ``_block_dist`` asserts
it.

Not ported yet: the ring (``pairwise_topk_ring``, ``_ring_bins``,
``_merge_bins``) and the 2-D model-axis sharding, which are multi-device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def topk_smallest(dist: torch.Tensor, k: int, method: str = "exact"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest ``(values, int32 indices)``, ascending, lowest
    index first on ties (``lax.top_k``'s order).  An integer ``dist`` is
    selected on the unique int64 key ``(value << 32) | index``, because
    ``torch.topk`` does not order ties; a float ``dist`` takes a stable
    sort.  ``method='approx'`` (the reference's ``lax.approx_min_k``) has
    no PyTorch counterpart and is answered exactly."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown top-k method {method!r}; "
                         "use 'exact' or 'approx'")
    nt = dist.shape[-1]
    if not dist.dtype.is_floating_point:
        key = ((dist.to(torch.int64) << 32)
               | torch.arange(nt, dtype=torch.int64, device=dist.device))
        kv = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        return (kv >> 32).to(dist.dtype), (kv & 0xFFFFFFFF).to(torch.int32)
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _assert_no_tf32(device: torch.device) -> None:
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision()
                                  != "highest"):
        raise RuntimeError(
            "TF32 matmul is enabled; the distance engine needs full float32 "
            "products (torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.set_float32_matmul_precision('highest'))")


def _block_dist(qnum: torch.Tensor, qcat: torch.Tensor, tnum: torch.Tensor,
                tcat: torch.Tensor, wcat: torch.Tensor, wsum: float,
                algorithm: str, scale: int) -> torch.Tensor:
    """Int-scaled distance block ``[nq, nt]`` (int32).  ``qnum``/``tnum``
    are range-normalized float32 columns with the weights folded in,
    ``qcat``/``tcat`` int32 codes, ``wcat`` float32 per-column weights.
    The manhattan and categorical sums run left to right over the
    columns, the order kernel K3 uses."""
    dev = qnum.device
    parts = None
    if qnum.shape[1]:
        if algorithm == "euclidean":
            _assert_no_tf32(dev)
            q2 = (qnum * qnum).sum(dim=1)[:, None]
            t2 = (tnum * tnum).sum(dim=1)[None, :]
            cross = torch.matmul(qnum, tnum.T)
            parts = (q2 + t2 - 2.0 * cross).clamp_min(0.0)
        else:
            for c in range(qnum.shape[1]):
                term = (qnum[:, c:c + 1] - tnum[None, :, c]).abs()
                parts = term if parts is None else parts + term
    cat = None
    for c in range(qcat.shape[1]):
        term = (qcat[:, c:c + 1] != tcat[None, :, c]).to(torch.float32) \
            * wcat[c]
        cat = term if cat is None else cat + term
    if cat is not None:
        parts = cat if parts is None else parts + cat
    # divide by a tensor: a Python-scalar divisor may become a multiply
    # by its reciprocal on the card, which rounds differently
    d = parts / torch.tensor(wsum, dtype=torch.float32, device=dev)
    if algorithm == "euclidean":
        d = torch.sqrt(d)
    # the clamp keeps the int cast defined, as the fused kernels do
    return (d * scale).clamp_max(2147483392.0).to(torch.int32)


def _fold_weights(qnum, tnum, num_weights, cat_weights, algorithm):
    """Fold the attribute weights into the numeric columns (their square
    roots for the euclidean expansion); returns ``(qnum', tnum', wsum)``
    as float32 host arrays and a float."""
    wsum = float(num_weights.sum() + cat_weights.sum()) or 1.0
    wn = np.sqrt(num_weights) if algorithm == "euclidean" else num_weights
    return ((qnum * wn[None, :]).astype(np.float32),
            (tnum * wn[None, :]).astype(np.float32), wsum)


def _dense(qnum, qcat, tnum, tcat, wcat, wsum, algorithm, scale
           ) -> np.ndarray:
    """The whole ``[nq, nt]`` block, a block of query rows at a time."""
    from .topk import _BLOCK_ELEMS

    nq, nt = qnum.shape[0], tnum.shape[0]
    step = max(_BLOCK_ELEMS // max(nt, 1), 1)
    out = np.zeros((nq, nt), np.int32)
    for lo in range(0, nq, step):
        hi = min(lo + step, nq)
        out[lo:hi] = _block_dist(qnum[lo:hi], qcat[lo:hi], tnum, tcat, wcat,
                                 wsum, algorithm, scale).cpu().numpy()
    return out


def pairwise_distances(qnum: np.ndarray, qcat: np.ndarray,
                       tnum: np.ndarray, tcat: np.ndarray,
                       num_weights: np.ndarray, cat_weights: np.ndarray,
                       algorithm: str = "euclidean", scale: int = 1000,
                       top_k: Optional[int] = None, device=None,
                       topk_method: str = "exact",
                       stats: Optional[dict] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """All-pairs int-scaled distances between query and training rows.

    Returns ``(dist[nq, nt], None)`` or, with ``top_k``, the per-query
    ``(dist[nq, k], index[nq, k])`` nearest training rows, ascending, lowest
    index first on ties.  ``topk_method``: ``'exact'`` (default) takes the
    fused engine K3 when ``ops.topk.k3_applicable`` allows (on a CUDA
    device, within K3's own limits), else the sorted engine; ``'fused'``
    / ``'sorted'`` force one (``'fused'`` within the reference's limits,
    ``ops.topk.fused_topk_supported``); ``'approx'`` is answered exactly
    by the sorted engine.  Rows the fused engine flags as suspect are
    re-resolved through the sorted engine with the unfolded operands, as
    the reference does (K3 flags none).  With ``stats`` (a dict)
    the call records ``engine`` ('fused', 'sorted' or 'dense') and
    ``reresolved`` (the count of re-resolved rows).
    """
    from .topk import (fused_pairwise_topk, fused_topk_supported,
                       k3_applicable, plain_pairwise_topk)

    dev = resolve_device(device)
    nt = tnum.shape[0]
    qnum0, tnum0 = qnum, tnum
    qnum, tnum, wsum = _fold_weights(qnum, tnum, num_weights, cat_weights,
                                     algorithm)
    if stats is None:
        stats = {}
    stats.update(engine="dense" if not top_k else "sorted", reresolved=0)

    def dev_args():
        return (torch.from_numpy(np.ascontiguousarray(qnum)).to(dev),
                torch.from_numpy(np.ascontiguousarray(qcat, np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(tnum)).to(dev),
                torch.from_numpy(np.ascontiguousarray(tcat, np.int32)).to(dev),
                torch.from_numpy(np.asarray(cat_weights, np.float32)).to(dev))

    k0 = min(top_k, nt) if top_k else None
    if k0 is not None and topk_method in ("exact", "fused"):
        n_num, n_cat = qnum.shape[1], qcat.shape[1]
        if topk_method == "fused" and not fused_topk_supported(
                algorithm, k0, nt, n_num, n_cat, scale):
            raise ValueError("fused top-k not supported for this shape; "
                             "use topk_method='exact'")
        if topk_method == "fused" or k3_applicable(
                algorithm, k0, qnum.shape[0], nt, n_num, n_cat, device=dev):
            qn, qc, tn, tc, wc = dev_args()
            vals, idxs, suspect = fused_pairwise_topk(
                qn, qc, tn, tc, wc, wsum, scale, k0, algorithm=algorithm)
            vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
            bad = np.flatnonzero(suspect.cpu().numpy())
            stats.update(engine="fused", reresolved=int(bad.size))
            if bad.size:
                # the unfolded operands: the recursive call folds the
                # weights itself
                vals[bad], idxs[bad] = pairwise_distances(
                    qnum0[bad], qcat[bad], tnum0, tcat, num_weights,
                    cat_weights, algorithm=algorithm, scale=scale,
                    top_k=k0, device=dev, topk_method="sorted")
            return vals, idxs
    if topk_method == "fused":
        raise ValueError("topk_method='fused' requires top_k")
    if topk_method not in ("exact", "sorted", "approx"):
        raise ValueError(f"unknown top-k method {topk_method!r}")
    if k0 is None:
        return _dense(*dev_args(), wsum, algorithm, scale), None
    # the sorted engine is K3's plain version: the same blocks and the
    # same exact selection
    vals, idxs, _ = plain_pairwise_topk(*dev_args(), wsum, scale, k0,
                                        algorithm)
    return vals.cpu().numpy(), idxs.cpu().numpy()
