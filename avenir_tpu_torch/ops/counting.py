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
sums the tables, as the reference's ``shard_map`` + ``psum`` does.

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
