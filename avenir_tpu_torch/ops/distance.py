"""Pairwise distances and exact top-k on one device: the engine behind the
kNN distance job.

Counterpart of ``avenir_tpu/ops/distance.py``.  Per-attribute distances
(numeric columns range-normalized by the caller, categorical columns 0/1
mismatch), weight-averaged over the attributes and scaled to int by
``distance.scale``.  Two exact engines, as in the reference:

- the fused engine, kernel K3 (``ops.topk.fused_pairwise_topk``), which
  never materializes the ``[nq, nt]`` block; taken automatically on a
  CUDA device within K3's own limits (``ops.topk.k3_applicable``: the
  measured crossover has K3 faster at every shape);
- the sorted engine: ``_block_dist`` on a block of query rows (the
  euclidean cross term is one ``torch.matmul``, which the reference left
  to XLA outside Pallas), then ``topk_smallest``.

The two engines compute the cross term in different orders, so a distance
that lands on an int-scale rounding boundary may differ by one unit
between them (the reference's own contract, ``distance.py:454-458``).
Float32 matrix products here run without TF32: ``_block_dist`` asserts
it.

``ResidentTraining`` moves the training side (weight-folded) to the
device once; ``resident_distances`` then moves only the queries (the
serving kNN adapter), and ``pairwise_distances`` is the one-shot form
the batch job calls.

On a mesh (``parallel.mesh``): ``pairwise_distances(..., mesh=)`` shards
the query rows over ``data`` and the candidate rows over ``model`` (the
reference's 2-D engines, ``distance.py:504-553``), and
``pairwise_topk_ring`` shards both over ``data`` and rotates the
candidate blocks around the ring (``distance.py:162-440``).  Every exact
engine on a mesh gives the one-device answer; only the ring's ``sort``
selection keeps the reference's arrival order among equal distances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import (gather, get_mesh, ppermute_ring, shard_grid,
                             split_rows, to_device)


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


def _assert_no_tf32(device: torch.device,
                    user: str = "the distance engine") -> None:
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision()
                                  != "highest"):
        raise RuntimeError(
            f"TF32 matmul is enabled; {user} needs full float32 "
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


def _fold(x, num_weights, algorithm) -> np.ndarray:
    """Fold the attribute weights into one side's numeric columns (their
    square roots for the euclidean expansion), as a float32 host array."""
    wn = np.sqrt(num_weights) if algorithm == "euclidean" else num_weights
    return (x * wn[None, :]).astype(np.float32)


def _weight_sum(num_weights, cat_weights) -> float:
    return float(num_weights.sum() + cat_weights.sum()) or 1.0


def _fold_weights(qnum, tnum, num_weights, cat_weights, algorithm):
    """Both sides folded (``_fold``) and the summed weights: ``(qnum',
    tnum', wsum)``."""
    return (_fold(qnum, num_weights, algorithm),
            _fold(tnum, num_weights, algorithm),
            _weight_sum(num_weights, cat_weights))


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


class ResidentTraining:
    """The training side of ``pairwise_distances``, weight-folded and
    moved to ``device`` once: ``tn`` (float32, the weights folded in),
    ``tc`` (int32 codes), ``wc`` (float32 categorical weights) and
    ``wsum``.  The serving kNN adapter builds one at load and passes it
    with every batch, so the training set crosses to the card once; the
    unfolded host arrays stay for re-resolving flagged rows."""

    def __init__(self, tnum: np.ndarray, tcat: np.ndarray,
                 num_weights: np.ndarray, cat_weights: np.ndarray,
                 algorithm: str = "euclidean", device=None):
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.tnum, self.tcat = tnum, tcat
        self.num_weights = np.asarray(num_weights)
        self.cat_weights = np.asarray(cat_weights)
        self.wsum = _weight_sum(self.num_weights, self.cat_weights)
        dev = self.device
        self.tn = torch.from_numpy(np.ascontiguousarray(
            _fold(tnum, self.num_weights, algorithm))).to(dev)
        self.tc = torch.from_numpy(
            np.ascontiguousarray(tcat, np.int32)).to(dev)
        self.wc = torch.from_numpy(
            np.asarray(self.cat_weights, np.float32)).to(dev)

    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size())
                   for t in (self.tn, self.tc, self.wc))


def pairwise_distances(qnum: np.ndarray, qcat: np.ndarray,
                       tnum: np.ndarray, tcat: np.ndarray,
                       num_weights: np.ndarray, cat_weights: np.ndarray,
                       algorithm: str = "euclidean", scale: int = 1000,
                       top_k: Optional[int] = None, device=None,
                       topk_method: str = "exact",
                       stats: Optional[dict] = None, mesh=None
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

    With ``mesh`` (in place of ``device``) the query rows shard over the
    mesh's ``data`` axis and the candidate rows over ``model``: the fused
    engine is ``fused_pairwise_topk(..., mesh=)``, and the sorted engine
    takes each tile's k smallest, then the k smallest of the model shards'
    lists laid side by side.  Both give the one-device answer.
    """
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a device or a mesh, not both")
        return _mesh_distances(qnum, qcat, tnum, tcat, num_weights,
                               cat_weights, algorithm, scale, top_k,
                               topk_method, stats, mesh)
    train = ResidentTraining(tnum, tcat, num_weights, cat_weights,
                             algorithm, device)
    return resident_distances(qnum, qcat, train, scale=scale, top_k=top_k,
                              topk_method=topk_method, stats=stats)


def resident_distances(qnum: np.ndarray, qcat: np.ndarray,
                       train: ResidentTraining, scale: int = 1000,
                       top_k: Optional[int] = None,
                       topk_method: str = "exact",
                       stats: Optional[dict] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``pairwise_distances`` against a training set already on its
    device (:class:`ResidentTraining`): only the queries move."""
    from .topk import fused_pairwise_topk, plain_pairwise_topk

    dev, algorithm, wsum = train.device, train.algorithm, train.wsum
    nt = train.tn.shape[0]
    qfold = _fold(qnum, train.num_weights, algorithm)
    k0 = min(top_k, nt) if top_k else None
    engine = _choose_engine(topk_method, algorithm, k0, nt, qfold.shape[1],
                            qcat.shape[1], scale, dev)
    args = (torch.from_numpy(np.ascontiguousarray(qfold)).to(dev),
            torch.from_numpy(np.ascontiguousarray(qcat, np.int32)).to(dev),
            train.tn, train.tc, train.wc)
    if engine == "fused":
        return _fused_answer(
            fused_pairwise_topk(*args, wsum, scale, k0, algorithm=algorithm),
            stats, qnum, qcat, train.tnum, train.tcat, train.num_weights,
            train.cat_weights, algorithm, scale, k0, device=dev)
    _record(stats, engine)
    if engine == "dense":
        return _dense(*args, wsum, algorithm, scale), None
    # the sorted engine is K3's plain version: the same blocks and the
    # same exact selection
    vals, idxs, _ = plain_pairwise_topk(*args, wsum, scale, k0, algorithm)
    return vals.cpu().numpy(), idxs.cpu().numpy()


def _choose_engine(topk_method: str, algorithm: str, k0: Optional[int],
                   nt: int, n_num: int, n_cat: int, scale: int,
                   device: torch.device, m_ax: int = 1) -> str:
    """The engine of a ``pairwise_distances`` call on ``device`` (a mesh's
    first device, ``m_ax`` its model shards): ``'fused'``, ``'sorted'``
    or, without ``top_k``, ``'dense'``, after the reference's checks of
    ``topk_method``."""
    from .topk import fused_topk_supported, k3_applicable

    if topk_method not in ("exact", "fused", "sorted", "approx"):
        raise ValueError(f"unknown top-k method {topk_method!r}")
    if k0 is None:
        if topk_method == "fused":
            raise ValueError("topk_method='fused' requires top_k")
        return "dense"
    if topk_method == "fused":
        if not fused_topk_supported(algorithm, k0, nt, n_num, n_cat, scale,
                                    m_ax=m_ax):
            raise ValueError("fused top-k not supported for this shape; "
                             "use topk_method='exact'")
        return "fused"
    if topk_method == "exact" and k3_applicable(algorithm, k0, n_num, n_cat,
                                                device=device):
        return "fused"
    return "sorted"


def _record(stats: Optional[dict], engine: str, reresolved: int = 0) -> None:
    if stats is not None:
        stats.update(engine=engine, reresolved=reresolved)


def _fused_answer(answer, stats, qnum, qcat, tnum, tcat, num_weights,
                  cat_weights, algorithm, scale, k0, **place):
    """The fused engine's ``(dist, idx, suspect)`` as host arrays, the rows
    it flags re-resolved through the sorted engine on the same ``device``
    or ``mesh`` (``place``) with the unfolded operands, as the reference
    does (K3 flags none)."""
    vals, idxs, suspect = answer
    vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
    bad = np.flatnonzero(suspect.cpu().numpy())
    _record(stats, "fused", int(bad.size))
    if bad.size:
        vals[bad], idxs[bad] = pairwise_distances(
            qnum[bad], qcat[bad], tnum, tcat, num_weights, cat_weights,
            algorithm=algorithm, scale=scale, top_k=k0,
            topk_method="sorted", **place)
    return vals, idxs


# ---------------------------------------------------------------------------
# on a mesh: the 2-D engines and the ring
# ---------------------------------------------------------------------------

def _host_tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mesh_distances(qnum, qcat, tnum, tcat, num_weights, cat_weights,
                    algorithm, scale, top_k, topk_method, stats, mesh):
    """``pairwise_distances`` on a ``(data, model)`` mesh
    (``distance.py:504-553``)."""
    from .topk import fused_pairwise_topk, plain_pairwise_topk

    d_ax, m_ax = mesh.shape["data"], mesh.shape["model"]
    nq, nt = qnum.shape[0], tnum.shape[0]
    qf, tf, wsum = _fold_weights(qnum, tnum, num_weights, cat_weights,
                                 algorithm)
    q, qc, t, tc, wc = _host_tensors(
        qf, np.asarray(qcat, np.int32), tf, np.asarray(tcat, np.int32),
        np.asarray(cat_weights, np.float32))
    k0 = min(top_k, nt) if top_k else None
    engine = _choose_engine(topk_method, algorithm, k0, nt, qf.shape[1],
                            qc.shape[1], scale, mesh.devices[0, 0], m_ax)
    if engine == "fused":
        return _fused_answer(
            fused_pairwise_topk(q, qc, t, tc, wc, wsum, scale, k0, algorithm,
                                mesh=mesh),
            stats, qnum, qcat, tnum, tcat, num_weights, cat_weights,
            algorithm, scale, k0, mesh=mesh)
    _record(stats, engine)
    Q, QC = shard_grid(q, mesh, "data"), shard_grid(qc, mesh, "data")
    T, TC = shard_grid(t, mesh, "model"), shard_grid(tc, mesh, "model")
    W = shard_grid(wc, mesh)
    t_loc = -(-nt // m_ax)
    if engine == "dense":
        out = np.zeros((nq, nt), np.int32)
        q_loc = -(-nq // d_ax)
        for i in range(d_ax):
            for j in range(m_ax):
                out[i * q_loc:(i + 1) * q_loc, j * t_loc:(j + 1) * t_loc] = \
                    _dense(Q[i][j], QC[i][j], T[i][j], TC[i][j], W[i][j],
                           wsum, algorithm, scale)
        return out, None
    vals, idxs = [], []
    for i in range(d_ax):
        # each tile's k smallest with global indices, laid side by side in
        # model order (global index order), then the k smallest of those:
        # lowest index first on ties, as on one device
        vs, ix = [], []
        for j in range(m_ax):
            nt_j = T[i][j].shape[0]
            v, x, _ = plain_pairwise_topk(Q[i][j], QC[i][j], T[i][j],
                                          TC[i][j], W[i][j], wsum, scale,
                                          min(k0, nt_j), algorithm)
            vs.append(v)
            ix.append(x + j * t_loc)
        home = mesh.devices[i, 0]
        v, pos = topk_smallest(gather(vs, home, dim=1), k0)
        vals.append(v.cpu().numpy())
        idxs.append(torch.take_along_dim(gather(ix, home, dim=1),
                                         pos.long(), dim=1).cpu().numpy())
    return np.concatenate(vals), np.concatenate(idxs)


def pairwise_topk_ring(qnum: np.ndarray, qcat: np.ndarray,
                       tnum: np.ndarray, tcat: np.ndarray,
                       num_weights: np.ndarray, cat_weights: np.ndarray,
                       k: int, algorithm: str = "euclidean",
                       scale: int = 1000, mesh=None, selection: str = "auto",
                       stats: Optional[dict] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query k nearest training rows with both operands sharded over
    the mesh's ``data`` axis (``distance.py:162``): each shard holds its
    query rows and one block of ``ceil(nt / d)`` training rows; at each of
    ``d`` hops it selects against the block it holds and then passes the
    block to its ring neighbour (``ppermute_ring``), so no shard ever holds
    the whole training matrix.

    ``selection='bins'`` runs K3 on each hop's tile, its lists written as
    keys with the hop's global index base (``ops.topk.segment_keys``), and
    one merge launch folds them into the shard's carry
    (``ops.topk.merge_topk_keys``), whose k-th values seed the next hop's
    K3.  The reference carried packed bins there and re-resolved the rows
    whose bins overflowed; the port's lists are exact, so the answer is
    the one-device answer, ties included, and no row re-resolves (the
    reference's re-resolve path stays, counted in ``stats``).
    ``selection='sort'`` selects per hop over ``[carry | hop]``, carry
    first, as the reference's does, so among equal distances it keeps
    arrival order.  ``'auto'`` takes ``bins`` where the fused engine's
    gate (``ops.topk.k3_applicable``) holds on the mesh's device and the
    shape is inside the reference's limits (``fused_topk_supported`` with
    ``m_ax = d``, to which a forced ``bins`` is held), else ``sort``.  On
    the CPU, ``bins`` runs the kernels' plain versions.

    Returns host ``(dist [nq, k], idx [nq, k])`` with global training-row
    indices, ascending.  With ``stats`` the call records ``selection`` and
    ``reresolved``.
    """
    from .topk import fused_topk_supported, k3_applicable

    mesh = mesh or get_mesh()
    d = mesh.shape["data"]
    nt = tnum.shape[0]
    k = min(k, nt)
    qf, tf, wsum = _fold_weights(qnum, tnum, num_weights, cat_weights,
                                 algorithm)
    n_num, n_cat = qf.shape[1], qcat.shape[1]
    if selection == "auto":
        # the broadcast engine's device gate, within the limits that a
        # forced 'bins' is held to (the reference's gate includes both)
        selection = ("bins" if k3_applicable(algorithm, k, n_num, n_cat,
                                             device=mesh.devices[0, 0])
                     and fused_topk_supported(algorithm, k, nt, n_num,
                                              n_cat, scale, m_ax=d)
                     else "sort")
    if stats is None:
        stats = {}
    stats.update(selection=selection, reresolved=0)
    if selection == "bins":
        if not fused_topk_supported(algorithm, k, nt, n_num, n_cat, scale,
                                    m_ax=d):
            raise ValueError("ring selection='bins' needs shapes inside "
                             "the fused engine's caps; use "
                             "selection='sort'")
    elif selection != "sort":
        raise ValueError(f"unknown ring selection {selection!r}; "
                         "use 'auto', 'bins' or 'sort'")
    devs = mesh.axis_devices("data")
    q, qc, t, tc, wc = _host_tensors(
        qf, np.asarray(qcat, np.int32), tf, np.asarray(tcat, np.int32),
        np.asarray(cat_weights, np.float32))
    qs = [to_device(x.contiguous(), dev)
          for x, dev in zip(split_rows(q, d), devs)]
    qcs = [to_device(x.contiguous(), dev)
           for x, dev in zip(split_rows(qc, d), devs)]
    blocks = [[to_device(x.contiguous(), dev) for x, dev in
               zip(split_rows(a, d), devs)] for a in (t, tc)]
    wcs = [to_device(wc, dev) for dev in devs]
    ring = _ring_bins if selection == "bins" else _ring_sort
    vals, idxs, suspect = (
        np.concatenate([x.cpu().numpy() for x in shards]) for shards in
        ring(qs, qcs, blocks, wcs, wsum, scale, k, algorithm, -(-nt // d)))
    # the reference's re-resolve of suspect rows (distance.py:220-229)
    bad = np.flatnonzero(suspect)
    stats["reresolved"] = int(bad.size)
    if bad.size:
        vals[bad], idxs[bad] = pairwise_distances(
            qnum[bad], qcat[bad], tnum, tcat, num_weights, cat_weights,
            algorithm=algorithm, scale=scale, top_k=k, mesh=mesh,
            topk_method="sorted")
    return vals, idxs


def _ring_bins(qs, qcs, blocks, wcs, wsum, scale, k, algorithm, m):
    """The ring's ``bins`` selection (``distance.py:301``): per shard a
    scratch ``[1 + S, nq_loc, k]`` of int64 keys whose list 0 is the carry;
    each hop's K3 writes its S segment lists, with global indices
    ``owner * m + row``, into lists 1..S, and one merge launch folds lists
    0..S back into list 0 and the carry's k-th values, which bound the next
    hop's K3.  The last hop's merge gives ``(dist, idx)``; the lists are
    exact, so no row is suspect.  Returns per-shard ``(dist, idx,
    suspect)``.  The reference
    segmented each hop at ``_SEG = 2^18`` rows for its int32 packing
    budget; K3 has none, so a hop takes K3's own plan (``device_plan``)."""
    from .topk import (_SENT, _SENT64, device_plan, merge_topk_keys,
                       merge_topk_lists, segment_keys)

    d = len(qs)
    splits = [max(device_plan(q.shape[0], b.shape[0], q.device)[1]
                  for b in blocks[0]) for q in qs]
    carry = [torch.full((1 + s, q.shape[0], k), _SENT64, dtype=torch.int64,
                        device=q.device) for s, q in zip(splits, qs)]
    kth = [torch.full((q.shape[0],), _SENT, dtype=torch.int32,
                      device=q.device) for q in qs]
    tn_b, tc_b = blocks
    out = [None] * d
    for hop in range(d):
        for r in range(d):
            owner = (r + hop) % d
            S = device_plan(qs[r].shape[0], tn_b[r].shape[0],
                            qs[r].device)[1]
            segment_keys(qs[r], qcs[r], tn_b[r], tc_b[r], wcs[r], wsum,
                         scale, k, algorithm, base=owner * m,
                         out=carry[r][1:1 + S], kth=kth[r])
            if hop < d - 1:
                merge_topk_keys(carry[r][:1 + S], carry[r][0], kth[r])
            else:
                out[r] = merge_topk_lists(carry[r][:1 + S])
        if hop < d - 1:
            tn_b, tc_b = ppermute_ring(tn_b), ppermute_ring(tc_b)
    return ([o[0] for o in out], [o[1] for o in out],
            [torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
             for q in qs])


def _ring_sort(qs, qcs, blocks, wcs, wsum, scale, k, algorithm, m):
    """The ring's ``sort`` selection (``distance.py:237-296``): at each hop
    the hop's distance tile beside the carry, carry first, and the k
    smallest of the row, a block of query rows at a time.  Returns
    per-shard ``(dist, idx, suspect)`` (an exact selection: no row is
    suspect)."""
    from .topk import _BLOCK_ELEMS, _SENT

    d = len(qs)
    vals = [torch.full((q.shape[0], k), _SENT, dtype=torch.int32,
                       device=q.device) for q in qs]
    idxs = [torch.full((q.shape[0], k), -1, dtype=torch.int32,
                       device=q.device) for q in qs]
    tn_b, tc_b = blocks
    for hop in range(d):
        for r in range(d):
            owner = (r + hop) % d
            nq_r, m_r = qs[r].shape[0], tn_b[r].shape[0]
            gidx = (owner * m + torch.arange(m_r, dtype=torch.int32,
                                             device=qs[r].device))
            step = max(_BLOCK_ELEMS // max(m_r + k, 1), 1)
            for lo in range(0, nq_r, step):
                hi = min(lo + step, nq_r)
                db = _block_dist(qs[r][lo:hi], qcs[r][lo:hi], tn_b[r],
                                 tc_b[r], wcs[r], wsum, algorithm, scale)
                cand_v = torch.cat([vals[r][lo:hi], db], dim=1)
                cand_i = torch.cat([idxs[r][lo:hi],
                                    gidx.expand(hi - lo, m_r)], dim=1)
                v, pos = topk_smallest(cand_v, k)
                vals[r][lo:hi] = v
                idxs[r][lo:hi] = torch.take_along_dim(cand_i, pos.long(),
                                                      dim=1)
        if hop < d - 1:
            tn_b, tc_b = ppermute_ring(tn_b), ppermute_ring(tc_b)
    return vals, idxs, [torch.zeros(q.shape[0], dtype=torch.bool,
                                    device=q.device) for q in qs]
