"""The counting engine on one device: dense group-by-composite-key counts.

Counterpart of ``avenir_tpu/ops/counting.py``.  Every batch trainer
reduces its records to a small dense table ``C[k1, k2, ...] += w``; the
Naive Bayes base table ``C[class, feature, bin]`` is the one the main path
runs.  On a CUDA tensor ``feature_class_counts`` always launches the
hand-written histogram kernel K1 and ``feature_class_counts_rawbin``
kernel K2 (``ops.histogram``); on a CPU tensor their plain PyTorch
versions run.  The TPU package's choice between an einsum, the Pallas
kernel and a scatter was a TPU decision and has no counterpart here.

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


def sharded_reduce(local_fn: Callable, *row_arrays, device: torch.device,
                   static_args: tuple = ()):
    """``local_fn(*arrays, mask, *static_args)`` over host arrays with a
    common leading row count, on one device.  The TPU package padded rows
    to the mesh and summed the shards' tables with ``psum``; with one
    device there is nothing to pad and no collective, so every row is
    valid and ``mask`` is None."""
    arrays = [torch.as_tensor(np.ascontiguousarray(a)).to(device)
              for a in row_arrays]
    return local_fn(*arrays, None, *static_args)
