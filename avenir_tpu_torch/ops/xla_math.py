"""XLA's CPU float64 ``exp``, reproduced bit for bit in plain PyTorch.

The JAX package computes its float64 Naive Bayes factors with
``jnp.exp``.  On the CPU, XLA does not call libm for that: it emits its
own Padé rational, whose nine multiply-adds the LLVM backend fuses into
FMA instructions.  ``torch.exp`` (and ``numpy.exp``) differ from it by up
to 2 ulp on about one input in seven, which shows in the raw float64
feature probabilities that ``output.feature.prob.only`` prints.

``exp_f64`` evaluates the same rational in the same order, with each FMA
emulated exactly in float64 by error-free transforms (Veltkamp-split
TwoProduct plus TwoSum, summed as ``s + (t + e)``).  Every step is one
eager elementwise op, each rounded once under IEEE-754, so the CPU and a
CUDA card give the same bits.  Keep it out of ``torch.compile`` and out
of any fused kernel: a compiler that contracts a multiply and an add
into a hardware FMA changes the rounding.

Matched against ``jax.jit(jnp.exp)`` of jax 0.9 on an x86-64 host with
FMA (tests/test_torch_bayesian.py).
"""

from __future__ import annotations

import struct

import torch


def _f64(bits: str) -> float:
    return struct.unpack(">d", bytes.fromhex(bits))[0]


_LO = _f64("C086232BDD7ABCD2")       # below: the result is 0
_HI = _f64("40862E42FEFA39EF")       # above: the result is +inf
_LOG2E = _f64("3FF71547652B82FE")
_LN2_HI = _f64("3FE62E4000000000")
_LN2_LO = _f64("3EB7F7D1CF79ABCA")
_P = (_f64("3F2089CDD5E44BE8"), _f64("3F9F06D10CCA2C7E"))
_Q = (_f64("3EC92EB6BC365FA0"), _f64("3F64AE39B508B6C0"),
      _f64("3FCD17099887E074"))
_ONE_BITS = 0x3FF0000000000000
_SPLIT = 134217729.0                 # 2^27 + 1, Veltkamp's splitter


def _split(a: torch.Tensor):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with the product kept exact: TwoProduct (``p + e ==
    a * b`` exactly), TwoSum of ``p + c`` (``s + t`` exactly), then
    ``s + (t + e)``.  ``b`` and ``c`` may be Python floats."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def fma_f32(a, b, c) -> torch.Tensor:
    """Single-rounding float32 ``a * b + c`` (the x86 ``vfmadd`` that
    XLA's backend contracts a multiply and an add into).  The float32
    product is exact in float64; the float64 sum is rounded to odd (its
    exact error from TwoSum decides the last bit), so that the final
    rounding to float32 is the correctly rounded FMA."""
    f64 = torch.float64
    dev = next(t.device for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (torch.as_tensor(t, dtype=torch.float32, device=dev).to(f64)
               for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((t > 0) == (s > 0), 1, -1)
    odd = (t != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    return torch.where(odd, bits + step, bits).view(f64).to(torch.float32)


# XLA's float32 log: the Cephes/Eigen polynomial, with the multiply-adds
# that the x86 backend contracts into FMAs
# (float32 constants, written as the float64 hex that LLVM IR uses)
_LOG_P = tuple(_f64(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_C1 = _f64("BF2BD01060000000")
_LOG_C2 = _f64("3FE6300000000000")
_SQRTHF = _f64("3FE6A09E60000000")
_MIN_NORM = 2.0 ** -126


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``log`` of a float32 tensor, equal bit for bit to XLA CPU's
    float32 ``log``: 0 and subnormals (XLA runs with denormals-are-zero)
    give -inf, +inf gives +inf, a negative or NaN input gives NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"log_f32 takes float32, got {x.dtype}")
    i32 = torch.int32
    bits = x.clamp_min(_MIN_NORM).view(i32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    xm = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = fma_f32(xm, fma_f32(xm, p[0], p[1]), p[2])
    y1 = fma_f32(xm, fma_f32(xm, p[3], p[4]), p[5])
    y2 = fma_f32(xm, fma_f32(xm, p[6], p[7]), p[8])
    y = fma_f32(x3, fma_f32(x3, fma_f32(x3, y, y1), y2), e * _LOG_C1)
    r = fma_f32(_LOG_C2, e, fma_f32(-0.5, x2, xm) + y)
    r = torch.where((x > 0) | torch.isnan(x), r,
                    torch.full_like(r, float("nan")))
    r = torch.where(torch.isnan(x), x, r)
    r = torch.where(x.abs() < _MIN_NORM, torch.full_like(r, float("-inf")),
                    r)
    return torch.where(x == float("inf"), x, r)


def exp_f64(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float64 tensor, equal bit for bit to XLA CPU's
    float64 ``exp``.  NaN stays NaN; below ``_LO`` gives 0, above
    ``_HI`` gives +inf."""
    if x.dtype != torch.float64:
        raise TypeError(f"exp_f64 takes float64, got {x.dtype}")
    t = x.clamp(_LO, _HI)
    n = torch.floor(_fma(t, _LOG2E, 0.5))
    g = _fma(-n, _LN2_LO, _fma(-n, _LN2_HI, t))
    g2 = g * g
    p = _fma(_fma(g2, _P[0], _P[1]), g2, 1.0) * g
    q = _fma(_fma(_fma(g2, _Q[0], _Q[1]), g2, _Q[2]), g2, 2.0)
    e = _fma(p / (q - p), 2.0, 1.0)
    # 2^n as s1^3 * s2, so that no factor leaves the normal range
    ni = torch.nan_to_num(n, nan=0.0).to(torch.int64).clamp(-2099, 2099)
    b = ni >> 2
    s1 = (b * (1 << 52) + _ONE_BITS).view(torch.float64)
    s2 = ((ni - 3 * b) * (1 << 52) + _ONE_BITS).view(torch.float64)
    out = e * s1 * s1 * s1 * s2
    out = torch.where(x < _LO, torch.zeros((), dtype=x.dtype,
                                           device=x.device), out)
    return torch.where(x > _HI, torch.full((), float("inf"), dtype=x.dtype,
                                           device=x.device), out)
