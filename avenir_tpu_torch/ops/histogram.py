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
went through the kernels.  The kernel has no row cap and no table cap of
its own: a table too large for one block's shared memory is accumulated
in global memory by the same kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .counting import bin_raw, count_table

K1_LAUNCHES = 0
K2_LAUNCHES = 0

_CODE_DTYPES = (torch.int8, torch.int32)
_fn = None


def reset_launch_counts() -> None:
    global K1_LAUNCHES, K2_LAUNCHES
    K1_LAUNCHES = 0
    K2_LAUNCHES = 0


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
# wrappers
# ---------------------------------------------------------------------------

def _check(x, y, mask, n_class: int, max_bins: int, out) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a 2-D tensor [n, F]")
    n, F = x.shape
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
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
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel():
    global _fn
    if _fn is None:
        from . import _build
        lib = _build.load("histogram")
        fn = lib.avenir_histogram
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, ci, vp, vp, ctypes.c_longlong, ci, ci, ci,
                       vp, vp]
        fn.restype = ci
        lib.avenir_cuda_error_string.argtypes = [ci]
        lib.avenir_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def _launch(x, y, mask, widths, out) -> bool:
    """Launch the kernel on the current stream; False if there was no
    work (no rows or no features), so no launch to count."""
    n, F = x.shape
    if n == 0 or F == 0:
        return False
    fn = _kernel()
    C, _, B = out.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), x.element_size(), y.data_ptr(),
                 y.element_size(),
                 None if mask is None else mask.data_ptr(),
                 None if widths is None else widths.data_ptr(),
                 n, F, C, B, out.data_ptr(), stream)
    if err != 0:
        from . import _build
        msg = _build.load("histogram").avenir_cuda_error_string(err)
        raise RuntimeError(f"histogram kernel launch failed: CUDA error "
                           f"{err} ({msg.decode()})")
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
    global K1_LAUNCHES
    _check(x, y, mask, n_class, max_bins, out)
    if x.device.type == "cpu":
        counts = plain_feature_class_counts(x, y, n_class, max_bins, mask)
        return counts if out is None else out.add_(counts)
    if out is None:
        out = torch.zeros((n_class, x.shape[1], max_bins), dtype=torch.int32,
                          device=x.device)
    if _launch(x, y, mask, None, out):
        K1_LAUNCHES += 1
    return out


def wide_feature_class_counts_rawbin(xraw: torch.Tensor, y: torch.Tensor,
                                     n_class: int, max_bins: int,
                                     widths: Sequence[int],
                                     mask: Optional[torch.Tensor] = None,
                                     out: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """K2: K1 over ``bin_raw(xraw, widths)``, with the binning done inside
    the kernel.  ``widths`` are the per-feature bucket divisors, each
    >= 1 (1 = passthrough); division truncates toward zero."""
    global K2_LAUNCHES
    widths = tuple(int(w) for w in widths)
    if any(w < 1 for w in widths):
        raise ValueError(f"bucket widths must be >= 1: {widths}")
    _check(xraw, y, mask, n_class, max_bins, out)
    if len(widths) != xraw.shape[1]:
        raise ValueError(f"widths has {len(widths)} entries for "
                         f"{xraw.shape[1]} features")
    if xraw.device.type == "cpu":
        counts = plain_feature_class_counts_rawbin(xraw, y, n_class, max_bins,
                                                   widths, mask)
        return counts if out is None else out.add_(counts)
    if out is None:
        out = torch.zeros((n_class, xraw.shape[1], max_bins),
                          dtype=torch.int32, device=xraw.device)
    w = torch.tensor(widths, dtype=torch.int32, device=xraw.device)
    if _launch(xraw, y, mask, w, out):
        K2_LAUNCHES += 1
    return out
