"""The counting engine: dense group-by-composite-key counts.

Counterpart of ``avenir_tpu/ops/counting.py``.  Every batch trainer
reduces its records to a small dense table ``C[k1, k2, ...] += w``; the
Naive Bayes base table ``C[class, feature, bin]`` is the one the main path
runs.  On a CUDA tensor ``feature_class_counts`` always launches the
hand-written histogram kernel K1 and ``feature_class_counts_rawbin``
kernel K2 (``ops.histogram``); on a CPU tensor their plain PyTorch
versions run.  The TPU package's choice between an einsum, the Pallas
kernel and a scatter was a TPU decision and has no counterpart here.
``sharded_reduce`` runs a count over the positions of a device mesh and
sums the tables, as the reference's ``shard_map`` + ``psum`` does;
``sharded_ngram_counts`` counts the sliding windows of one long symbol
stream cut into one chunk per position, each chunk reading the head of
the next through a halo.

Drop contract (shared by every function here): an element whose index is
out of range, or whose row is masked, adds nothing.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def count_table(sizes: Sequence[int], indices: Sequence[torch.Tensor],
                weights: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Dense count tensor ``C[sizes]`` with ``C[idx...] += w`` per element
    (``index_add_`` over the raveled key).  ``indices`` broadcast against
    each other; out-of-range or masked elements add nothing."""
    sizes = tuple(int(s) for s in sizes)
    idx = torch.broadcast_tensors(*[torch.as_tensor(i).to(torch.int64)
                                    for i in indices])
    shape = idx[0].shape
    valid = torch.ones(shape, dtype=torch.bool, device=idx[0].device)
    flat = torch.zeros(shape, dtype=torch.int64, device=idx[0].device)
    for size, i in zip(sizes, idx):
        valid &= (i >= 0) & (i < size)
        flat = flat * size + i
    if mask is not None:
        valid &= torch.as_tensor(mask, device=valid.device).expand(shape)
    if weights is None:
        w = valid.to(dtype)
    else:
        w = torch.where(valid, torch.as_tensor(weights, device=valid.device)
                        .to(dtype).expand(shape),
                        torch.zeros((), dtype=dtype, device=valid.device))
    flat = torch.where(valid, flat, 0)
    total = int(np.prod(sizes)) if sizes else 1
    out = torch.zeros(total, dtype=dtype, device=valid.device)
    out.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return out.reshape(sizes)


def bin_raw(xraw: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """Bucket binning of a raw integer matrix: column f divided by
    ``widths[f]``, truncating toward zero (Java integer division, so
    negative raws round toward zero, not toward -inf).  Width 1 passes
    values through.  Returns int32."""
    w = torch.tensor([int(v) for v in widths], dtype=torch.int32,
                     device=xraw.device)
    return torch.div(xraw.to(torch.int32), w[None, :], rounding_mode="trunc")


def feature_class_counts(x: torch.Tensor, y: torch.Tensor, n_class: int,
                         max_bins: int, mask: Optional[torch.Tensor] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C[class, feature, bin] += 1`` for every (row, feature) — the Naive
    Bayes base table, int32 ``[n_class, F, max_bins]``.  ``x`` is the
    binned ``[n, F]`` matrix (int8 or int32; -1 marks an unbinned column
    and adds nothing), ``y`` the class codes, ``mask`` drops whole rows.
    With ``out`` the counts are added into that table in place."""
    from .histogram import wide_feature_class_counts
    return wide_feature_class_counts(x, y, n_class, max_bins, mask=mask,
                                     out=out)


def feature_class_counts_rawbin(xraw: torch.Tensor, y: torch.Tensor,
                                n_class: int, max_bins: int,
                                widths: Sequence[int],
                                mask: Optional[torch.Tensor] = None,
                                out: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """``feature_class_counts(bin_raw(xraw, widths), ...)`` with the
    binning fused into the count: ``xraw`` holds raw bucket values,
    categorical codes and -1 for continuous columns; ``widths`` the
    per-feature bucket divisor (1 = passthrough)."""
    from .histogram import wide_feature_class_counts_rawbin
    return wide_feature_class_counts_rawbin(xraw, y, n_class, max_bins,
                                            widths, mask=mask, out=out)


def sharded_reduce(local_fn: Callable, *row_arrays,
                   device: Optional[torch.device] = None, mesh=None,
                   static_args: tuple = ()):
    """``local_fn(*arrays, mask, *static_args)`` over host arrays with a
    common leading row count.

    With ``device``: on that one device, every row valid and ``mask``
    None.  With ``mesh`` (the reference's form, ``counting.py:345``): the
    rows pad to a multiple of the mesh's position count (data and model
    flattened: counting is 1-D work), each position runs ``local_fn`` on
    its rows with its validity mask, and the tables are summed by the
    mesh's ``psum``.  The result lies on the mesh's first device."""
    if (device is None) == (mesh is None):
        raise ValueError("pass exactly one of device and mesh")
    if device is not None:
        arrays = [torch.as_tensor(np.ascontiguousarray(a)).to(device)
                  for a in row_arrays]
        return local_fn(*arrays, None, *static_args)
    from ..parallel.mesh import pad_rows, shard_rows
    n = mesh.size
    padded, mask = [], None
    for a in row_arrays:
        pa, mask = pad_rows(np.asarray(a), n)
        padded.append(shard_rows(pa, mesh, ("data", "model")))
    return sharded_reduce_resident(
        local_fn, *padded, mask=shard_rows(mask, mesh, ("data", "model")),
        mesh=mesh, static_args=static_args)


def sharded_reduce_resident(local_fn: Callable, *row_arrays, mask, mesh,
                            static_args: tuple = ()):
    """``sharded_reduce`` for rows already placed: each of ``row_arrays``
    and ``mask`` is one tensor per mesh position (``parallel.shard_rows``
    over ``('data', 'model')`` after ``pad_rows`` to the position count),
    so data that stays on the devices across calls is not moved again.
    Returns the ``psum`` of the positions' outputs (a tensor, or a tuple,
    list or dict of tensors) on the mesh's first device."""
    from ..parallel.mesh import psum
    outs = [local_fn(*shard, m, *static_args)
            for *shard, m in zip(*row_arrays, mask)]
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return psum(outs)[0]
    if isinstance(first, dict):
        return {key: psum([o[key] for o in outs])[0] for key in first}
    return type(first)(psum(list(parts))[0] for parts in zip(*outs))


def _ngram_windows(chunk: torch.Tensor, halo: torch.Tensor, w: int):
    """The ``w`` columns of every window that starts in ``chunk``: column
    ``i`` is the chunk shifted left by ``i`` with the halo after it."""
    ext = torch.cat([chunk, halo])
    n = chunk.shape[0]
    return tuple(ext[i:i + n] for i in range(w))


def _ngram_local(chunk, halo, sg, sg_halo, vocab_size: int, w: int,
                 n_seg: int) -> torch.Tensor:
    """One chunk's window counts (the reference's ``local``,
    ``counting.py:316-331``): a window holding a token < 0 adds nothing;
    with segment ids (``sg``) every token of a window must share one
    segment, which becomes the table's leading index."""
    cols = _ngram_windows(chunk, halo, w)
    if sg is None:
        return count_table((vocab_size,) * w, cols)
    scols = _ngram_windows(sg, sg_halo, w)
    same = torch.ones_like(scols[0], dtype=torch.bool)
    for sc in scols[1:]:
        same &= sc == scols[0]
    return count_table((n_seg,) + (vocab_size,) * w, (scols[0],) + cols,
                       mask=same)


def sharded_ngram_counts(stream, vocab_size: int, w: int, seg=None,
                         n_seg: int = 1, device: Optional[torch.device] = None,
                         mesh=None) -> torch.Tensor:
    """Counts of every length-``w`` window of one long symbol stream: the
    dense int32 ``[vocab_size] * w`` table (``[n_seg] + [vocab_size] * w``
    with ``seg``).

    Tokens < 0 (the -1 that separates sessions, and the padding) void
    every window that holds one.  With ``seg``, an int32 segment id per
    token, a window counts only when all its tokens share one segment,
    under that segment's index.

    With ``device``: the whole stream is one chunk on that device, so the
    windows are plain sliding windows.  With ``mesh`` (the reference's
    form, ``counting.py:249``): the stream, padded with -1, is cut into
    one chunk of ``max(ceil(L / d), w)`` tokens per mesh position, in the
    row-major order of ``('data', 'model')``; each position counts the
    windows that START in its chunk, reading the first ``w - 1`` tokens
    (and segment ids) of the next position's chunk as its halo through
    one ``ppermute_ring`` hop, and the last position's halo is -1.  The
    tables are summed by the mesh's ``psum`` onto its first device, where
    the result lies."""
    if (device is None) == (mesh is None):
        raise ValueError("pass exactly one of device and mesh")
    d = 1 if mesh is None else mesh.size
    stream = np.asarray(stream, dtype=np.int32)
    L = stream.shape[0]
    chunk_len = max(-(-max(L, 1) // d), w)
    padded = np.full(d * chunk_len, -1, dtype=np.int32)
    padded[:L] = stream
    segged = seg is not None
    if segged:
        seg_p = np.full(d * chunk_len, -1, dtype=np.int32)
        seg_p[:L] = np.asarray(seg, dtype=np.int32)
    if mesh is None:
        chunks = [torch.from_numpy(padded).to(device)]
        segs = [torch.from_numpy(seg_p).to(device)] if segged else [None]
    else:
        from ..parallel.mesh import shard_rows
        chunks = shard_rows(padded, mesh, ("data", "model"))
        segs = (shard_rows(seg_p, mesh, ("data", "model")) if segged
                else [None] * d)
    # the halo: the next position's head, one ring hop away; the last
    # position's wraps to the stream's head and is voided to -1
    heads = [torch.stack([c[:w - 1], s[:w - 1]]) if segged else c[:w - 1]
             for c, s in zip(chunks, segs)]
    if mesh is None:
        halos = [torch.full_like(heads[0], -1)]
    else:
        from ..parallel.mesh import ppermute_ring
        halos = ppermute_ring(heads)
        halos[-1] = torch.full_like(halos[-1], -1)
    outs = []
    for c, s, h in zip(chunks, segs, halos):
        if segged:
            outs.append(_ngram_local(c, h[0], s, h[1], vocab_size, w, n_seg))
        else:
            outs.append(_ngram_local(c, h, None, None, vocab_size, w, n_seg))
    if mesh is None:
        return outs[0]
    from ..parallel.mesh import psum
    return psum(outs)[0]
