"""XLA's CPU float math, reproduced bit for bit in plain PyTorch.

The JAX package's float results come from XLA's CPU backend, which does
not round as eager PyTorch does: it emits its own polynomials for
``exp``, ``log`` (float32) and ``erf_inv``, calls the host's glibc for a
float64 ``log``, and the LLVM backend fuses a multiply and an add into one
FMA instruction.  ``torch.exp`` differs from XLA's float64 ``exp`` by up
to 2 ulp on about one input in seven, and ``torch.erfinv`` from XLA's
``erf_inv`` on most inputs.  This module holds the reference's versions:

- ``fma_f64`` and ``fma_f32``: the single-rounding FMA, emulated exactly
  (error-free transforms and a rounding to odd);
- ``exp_f64`` (NB's float64 factors), ``log_f32`` (NB's and Markov's
  float32 logs), ``exp_f32`` (the learners' softmax);
- ``log_f64``: glibc 2.36's x86-64 FMA ``log``, table and all;
- ``erf_inv_f64`` and ``erf_inv_f32``: the last step of
  ``jax.random.normal`` (``ops/threefry.py``);
- ``sqrt_rn``: the correctly rounded square root.

Each replays the compiled code's operations in their order (read from
``--xla_dump_to`` and ``objdump -d`` of XLA's and glibc's object code),
with the FMAs where the backend put them.  Every step is one eager
elementwise op, each rounded once under IEEE-754, so the CPU and a CUDA
card give the same bits.  Keep it out of ``torch.compile`` and out of any
fused kernel: a compiler that contracts a multiply and an add into a
hardware FMA changes the rounding.  Two more rules hold for the callers:
divide two tensors (a CUDA card divides by a Python scalar, or divides
one, as a multiply by a reciprocal), and take square roots with
``sqrt_rn`` (the CPU build's ``torch.sqrt`` misrounds).

Matched against ``jax.jit`` of jax 0.9 on an x86-64 host with FMA and
AVX2 (tests/test_torch_bayesian.py, tests/test_torch_threefry.py).
"""

from __future__ import annotations

import struct

import numpy as np
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


def fma_f32(a, b, c) -> torch.Tensor:
    """Single-rounding float32 ``a * b + c`` (the x86 ``vfmadd`` that
    XLA's backend contracts a multiply and an add into).  The float32
    product is exact in float64; the float64 sum is rounded to odd (its
    exact error from TwoSum decides the last bit), so that the final
    rounding to float32 is the correctly rounded FMA.  ``b`` and ``c``
    may be Python floats (rounded to float32 first)."""
    f64 = torch.float64

    def wide(t):
        if isinstance(t, torch.Tensor):
            return t.to(torch.float32).to(f64)
        return float(np.float32(t))
    a, b, c = wide(a), wide(b), wide(c)
    p = a * b
    s, t = _two_sum(p, c)
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
    fma = fma_f64
    n = torch.floor(fma(t, _LOG2E, 0.5))
    g = fma(-n, _LN2_LO, fma(-n, _LN2_HI, t))
    g2 = g * g
    p = fma(fma(g2, _P[0], _P[1]), g2, 1.0) * g
    q = fma(fma(fma(g2, _Q[0], _Q[1]), g2, _Q[2]), g2, 2.0)
    e = fma(p / (q - p), 2.0, 1.0)
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


def fma_f64(a, b, c) -> torch.Tensor:
    """Single-rounding float64 ``a * b + c`` (x86 ``vfmadd...sd``).  The
    product is split exactly (TwoProduct), the three terms are summed
    exactly into ``vh + vl + tl`` (two TwoSums), and ``vl + tl`` is
    rounded to odd before the last rounding, so that the result is the
    correctly rounded FMA (Boldo and Melquiond's emulation).  ``b`` and
    ``c`` may be Python floats, which stay host scalars (a tensor op with
    a float64 scalar rounds once, on the CPU and on a card alike);
    finite inputs well inside the range."""
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, ul)
    vh, vl = _two_sum(uh, th)
    s, e = _two_sum(vl, tl)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    odd = (e != 0) & ((bits & 1) == 0)
    s = torch.where(odd, bits + step, bits).view(torch.float64)
    return vh + s


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (IEEE-754 ``sqrt``, what XLA's
    ``sqrt`` is on an x86 host).  A CUDA card's ``torch.sqrt`` is one;
    the CPU build's vectorized ``torch.sqrt`` misrounds about one input
    in a hundred, so on the CPU numpy's (the ``sqrtps``/``sqrtpd``
    instructions) computes it."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


def _two_sum(a, b):
    """``s + t == a + b`` exactly (Knuth); ``a`` may be a Python float."""
    s = b + a
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


# -- glibc's float64 ``log`` --------------------------------------------------
# XLA's CPU backend does not expand a float64 ``log``: it calls the host
# libm's.  On an x86-64 host with FMA and AVX2, glibc 2.36 dispatches to
# ``__log_fma``, its table-driven ``log`` compiled with FMA contraction.
# ``log_f64`` replays that machine code's operations in their order, with
# its constants: 128 (1/c, log c) pairs and the two polynomials.

_LOG_TAB_HEX = (
    "9fdee0c3f034f73f0090e6797fccd7bf1fe92c6a7813f73f00000dc2ee6fd7bf"
    "a0b5fa0860f2f63f00e05113e313d7bf7d8c131fa6d1f63f007828385bb8d6bf"
    "d1b4c50b49b1f63f00788090555dd6bfba0c2f334791f63f00001876d002d6bf"
    "234222189f71f63f00909086caa8d5bfd91ea5994f52f63f00500356434fd5bf"
    "c4248faa5633f63f00406bc337f6d4bf14dc9d6bb314f63f0050a8fda79dd4bf"
    "4c5cc65264f6f53f00a889399245d4bf4f2c91b567d8f53f00b8b039f4edd3bf"
    "de905bcbbcbaf53f00708f44ce96d3bf781ad9f2619df53f00a0bd171e40d3bf"
    "875646125680f53f008046efe2e9d2bfd36be7ce9763f53f00e030381b94d2bf"
    "937fa7e22547f53f0088da8cc53ed2bf83450642ff2af53f00902729e1e9d1bf"
    "dfbdb2db220ff53f00f8482b6d95d1bfd7de34478ff3f43f00f8b99a6741d1bf"
    "4028decf43d8f43f0098ef94d0edd0bfc8a378c03ebdf43f0010db18a59ad0bf"
    "8a25e0c37fa2f43f00b86352e647d0bf3484d4240588f43f00f0864522ebcfbf"
    "0b2d191bce6df43f00b017754a47cfbf541839d3d953f43f0030103d44a4cebf"
    "5a84b444273af43f00b0e9440d02cebffbf81541b520f43f00f07729a260cdbf"
    "b1f43eda8207f43f0090950401c0ccbf8ffe575d8feef33f001089562920ccbf"
    "e94c0ba0d9d5f33f0010818d1781cbbf2bc110c060bdf33f00d0d3ccc9e2cabf"
    "b8da752b24a5f33f0090122e4045cabf02d09fcd228df33f00f01d6877a8c9bf"
    "1c7a84c55b75f33f003048696d0cc9bfe236ad49ce5df33f00c045a62071c8bf"
    "40d44d987946f33f003014b48fd6c7bf24cbffce5c2ff33f0070623cb83cc7bf"
    "490da1757718f33f0060379b9aa3c6bf90393e37c801f33f00a0b754310bc6bf"
    "41f895bb4eebf23f003024767d73c5bfd1a919020ad5f23f0030c28f7bdcc4bf"
    "2afdb7a8f9bef23f0000d2512c46c4bfab1b0c7a1ca9f23f000083bc8ab0c3bf"
    "30b514607293f23f0000496b991bc3bff5a15757fa7df23f0040a4905487c2bf"
    "bf3b1d9bb368f23f00a079f8b9f3c1bfbdf58f839d53f23f00a02c25c860c1bf"
    "3b08c9aab73ef23f0020f7577fcec0bfb640a92b012af23f00a0fe49dc3cc0bf"
    "3241cc967915f23f00804bbcbd57bfbf9bfcd21d2001f23f004040960837bebf"
    "0b484d49f4ecf13f0040f93e9817bdbf69658f52f5d8f13f00a0d84e67f9bbbf"
    "7c7e571123c5f13f00602f2079dcbabfe926cb747cb1f13f008028e7c3c0b9bf"
    "b61a2c0c019ef13f00c072b346a6b8bfbd70b67bb08af13f0000acb3018db7bf"
    "b6bcef258a77f13f00003845f174b6bfda314c358d64f13f0080876d0e5eb5bf"
    "dd5f2790b951f13f00e0a1de5c48b4bf4cd232a40e3ff13f00a06a4dd933b3bf"
    "daf910728b2cf13f0060c5f87920b2bf31b5ec28301af13f00206298460eb1bf"
    "af3484dafb07f13f0000d26a6cfaafbfb36b4e0feef5f03f0040774a8ddaadbf"
    "ce9f2a5d06e4f03f000085e4ecbcabbf21a52c6344d2f03f00c0124089a1a9bf"
    "1a98e27ca7c0f03f00c002335888a7bfd136c6832faff03f0080d6675e71a5bf"
    "3913a098db9df03f008065498a5ca3bfdfe752afab8cf03f00401564e349a1bf"
    "fb284e2f9f7bf03f0080eb82c0729ebf198f358cb56af03f00805252f1559abf"
    "2cf9eca5ee59f03f008081cf623d96bf902cd1cd4949f03f0000aa8cfb2892bf"
    "a9adf0c6c638f03f0000f9207b318cbfa93279136528f03f0000aa5d351984bf"
    "4873ea272418f03f0000ecc2031278bf95b114060408f03f00002479090460bf"
    "1afa26f71fe0ef3f00009084f3ef6f3f74ea61c21ca1ef3f00003d3541dc873f"
    "2e9981b01063ef3f0080c2c4a3ce933fcdadee3cf625ef3f00008914c19f9b3f"
    "e7139103c8e9ee3f000011ced8b0a13fabb1cb7880aeee3f00c001d05b8aa53f"
    "9b0c9da21a74ee3f0080d840835ca93fb5990a83913aee3f008057ef6a27ad3f"
    "569a6009e001ee3f00c098e59875b03f98bb77e501caed3f00200de3f553b23f"
    "03917c0bf292ed3f0000388bdd2eb43fce5cfb66ac5ced3f00c057875906b63f"
    "9dde5eaa2c27ed3f00006a3576dab73fcd2c6b3e6ef2ec3f00601c4e43abb93f"
    "0279a7a26dbeec3f00600dbbc778bb3f6d08376d268bec3f0020e7321343bd3f"
    "04585dbd9458ec3f0060de71310abf3f8c9fbb33b526ec3f0040912b1567c03f"
    "3fe7ecee83f5eb3f00b092828547c13fc196db75fdc4eb3f0030cacd6e26c23f"
    "284a860c1e95eb3f0050c5a6d703c33f2c3eefc5e265eb3f0010333cc3dfc33f"
    "8b88c9674837eb3f00807a6b36bac43f4a301d214b09eb3f00f0d1283993c53f"
    "7eeff285e8dbea3f00f01824cd6ac63fa23d60311dafea3f009066ecf840c73f"
    "a758d33fe682ea3f00f01af5c015c83f8b7309ef4057ea3f0080f65429e9c83f"
    "274bab902a2cea3f0040f80236bbc93fd1f29313a001ea3f00002c1ced8bca3f"
    "1b3cdb249fd7e93f00d0015c515bcb3f90b1c70525aee93f00c0bccc6729cc3f"
    "2fce97f22e85e93f006048d535f6cc3f754ba4eeba5ce93f00c04634bdc1cd3f"
    "3848e79dc634e93f00e0cfb8018cce3fe652672f4f0de93f009017c00955cf3f"
    "9dd7ff8e52e6e83f00b81f126c0ed03f7c00cc9fcebfe83f00d0930eb871d03f"
    "0ec3bedac099e83f0070869e6bd4d03ffb1723aa2774e83f00d04b338736d13f"
    "089ab3ac004fe83f004823670d98d13f553e65e8492ae83f0080cce0fff8d13f"
    "6002f4950106e83f006863d75f59d23f29a3e06325e2e73f00a8140930b9d23f"
    "adb5dc77b3bee73f006043107218d33fc2259767aa9be73f0018ec6d2677d33f"
    "570617f20779e73f0030affb4fd5d33f0c13d6dbca56e73f00e02fe3ee32d43f"
)
_LN2HI = _f64("3FE62E42FEFA3800")
_LN2LO = _f64("3D2EF35793C76730")
_LOG_A = tuple(_f64(h) for h in (
    "BFE0000000000001", "3FD555555551305B", "BFCFFFFFFFEB4590",
    "3FC999B324F10111", "BFC55575E506C89F"))
_LOG_B = tuple(_f64(h) for h in (
    "BFE0000000000000", "3FD5555555555577", "BFCFFFFFFFFFFDCB",
    "3FC999999995DD0C", "BFC55555556745A7", "3FC24924A344DE30",
    "BFBFFFFFA4423D65", "3FBC7184282AD6CA", "BFB999EB43B068FF",
    "3FB78182F7AFD085", "BFB5521375D145CD"))
_LOG_OFF = 0x3FE6000000000000
_LOG_NEAR_LO = 0x3FEE000000000000      # 1 - 2^-4
_LOG_NEAR_SPAN = 0x308FFFFFFFFFF       # up to 1 + 0x1.09p-4
_LOG_TABLES: dict = {}


def _log_table(device: torch.device) -> torch.Tensor:
    t = _LOG_TABLES.get(device)
    if t is None:
        raw = bytes.fromhex("".join(_LOG_TAB_HEX))
        host = torch.frombuffer(bytearray(raw), dtype=torch.float64)
        t = _LOG_TABLES[device] = host.reshape(128, 2).to(device)
    return t


def _log_near_one(x: torch.Tensor) -> torch.Tensor:
    """glibc's path for ``x`` in [1 - 2^-4, 1 + 0x1.09p-4): log1p(r) as a
    polynomial in ``r = x - 1`` plus an exact split of ``r * r / 2``."""
    B = _LOG_B
    r = x - 1.0
    b2 = fma_f64(r, B[2], B[1])
    b5 = fma_f64(r, B[5], B[4])
    r2 = r * r
    b8 = fma_f64(r, B[8], B[7])
    b2 = fma_f64(r2, B[3], b2)
    b5 = fma_f64(r2, B[6], b5)
    r3 = r * r2
    p = fma_f64(r3, B[10], fma_f64(r2, B[9], b8))
    p = fma_f64(fma_f64(p, r3, b5), r3, b2)
    rhi = fma_f64(-2.0 ** 27, r, fma_f64(r, 2.0 ** 27, r))
    rhi2 = rhi * rhi
    rlo = r - rhi
    hi = fma_f64(rhi2, B[0], r)
    lo = fma_f64(rhi2, B[0], r - hi)
    lo = fma_f64(B[0] * rlo, r + rhi, lo)
    return hi + fma_f64(p, r3, lo)


def log_f64(x: torch.Tensor) -> torch.Tensor:
    """``log`` of a float64 tensor, equal bit for bit to glibc 2.36's
    x86-64 FMA ``log`` (what XLA CPU's float64 ``log`` calls): 0 gives
    -inf, a negative or NaN input NaN, +inf +inf, 1 gives +0."""
    if x.dtype != torch.float64:
        raise TypeError(f"log_f64 takes float64, got {x.dtype}")
    i64 = torch.int64
    ix0 = x.view(i64)
    # subnormals: scale by 2^52 and take 52 off the exponent
    sub = (ix0 > 0) & (ix0 < (1 << 52))
    ix = torch.where(sub, (x * 2.0 ** 52).view(i64) - (52 << 52), ix0)
    tmp = ix - _LOG_OFF
    i = (tmp >> 45) & 127
    kd = (tmp >> 52).to(torch.float64)
    z = (ix - (tmp & -(1 << 52))).view(torch.float64)
    tab = _log_table(x.device)[i.clamp(0, 127)]
    invc, logc = tab[..., 0], tab[..., 1]
    A = _LOG_A
    w = fma_f64(kd, _LN2HI, logc)
    r = fma_f64(z, invc, -1.0)
    a21 = fma_f64(r, A[2], A[1])
    hi = r + w
    r2 = r * r
    lo = fma_f64(kd, _LN2LO, (w - hi) + r)
    r3 = r * r2
    q = fma_f64(fma_f64(r, A[4], A[3]), r2, a21)
    main = fma_f64(r3, q, fma_f64(r2, A[0], lo)) + hi
    d = ix0 - _LOG_NEAR_LO
    near1 = (d >= 0) & (d <= _LOG_NEAR_SPAN) & (x != 1.0)
    # the path near 1 costs a few hundred eager ops: one check of the
    # inputs skips it when none takes it (the bits do not depend on it);
    # a CUDA graph being captured cannot read the check, and takes it
    both = x.is_cuda and torch.cuda.is_current_stream_capturing()
    out = (torch.where(near1, _log_near_one(x), main)
           if both or bool(near1.any()) else main)
    out = torch.where(x == 1.0, torch.zeros_like(out), out)
    out = torch.where(x == 0, torch.full_like(out, float("-inf")), out)
    out = torch.where((x < 0) | torch.isnan(x),
                      torch.full_like(out, float("nan")), out)
    return torch.where(x == float("inf"), x, out)


# -- XLA's float32 exp --------------------------------------------------------
# the Cephes polynomial that XLA's CPU backend emits inline, with the
# multiply-adds the x86 backend contracts
_EXPF_LO = _f64("C055F33340000000")
_EXPF_HI = _f64("4056333340000000")
_EXPF_LOG2E = _f64("3FF7154760000000")
_EXPF_C1 = _f64("3FE6300000000000")
_EXPF_C2 = _f64("BF2BD01060000000")
_EXPF_P = tuple(_f64(h) for h in (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000"))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, equal bit for bit to XLA CPU's
    float32 ``exp`` (the input clamps to [-87.8, 88.8] first)."""
    if x.dtype != torch.float32:
        raise TypeError(f"exp_f32 takes float32, got {x.dtype}")
    t = x.clamp(_EXPF_LO, _EXPF_HI)
    fx = torch.floor(fma_f32(t, _EXPF_LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma_f32(-fx, _EXPF_C1, t)
    r = fma_f32(-_EXPF_C2, fx, r)
    P = _EXPF_P
    p = fma_f32(r, P[0], P[1])
    for c in P[2:] + (0.5,):
        p = fma_f32(p, r, c)
    y = fma_f32(p, r * r, r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


# -- XLA's erf_inv (float64 and float32) --------------------------------------
# Giles' approximation as XLA's CHLO decomposition emits it: w =
# -log1p(-x*x) (XLA's log1p: a rational for |z| < 0.4142, else
# log(1 + z)), then a polynomial in w - 3.125 (or sqrt(w) - 3.25, or
# sqrt(w) - 5) by Horner's rule, every step one FMA on an x86 host.
_L1P_THRESH_F64 = _f64("3FDA827999FCEF32")
_L1P_DEN_F64 = tuple(_f64(h) for h in (
    "402E20359E903E37", "4054C30B52213498", "406BB86590FCFB56",
    "407351945DC908A5", "406B0DB13E48E066", "404E0F304466448E"))
_L1P_NUM_F64 = tuple(_f64(h) for h in (
    "3F07BC0962B395CA", "3FDFE818A0FE1A83", "401A509F46F4FA53",
    "403DE9738B8CB9C9", "404E798EB86C3351", "404C8E7597479A10",
    "40340A202D99830A"))
_L1P_THRESH_F32 = _f64("3FDA8279A0000000")
_L1P_DEN_F32 = tuple(_f64(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_L1P_NUM_F32 = tuple(_f64(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000"))
# float64: w < 6.25 (23 coefficients), w < 16 (19), w >= 16 (17)
_ERFINV_W6 = tuple(_f64(h) for h in (
    "BBB135D2E746E627", "BC08DDF93324D327", "3C37B83EEF0B7C9F",
    "3C69BA72CD589B91", "BCA33689090A6B96", "3C782E11898132E0",
    "3CFDE4ACFD9E26BA", "BD26D33EED66C487", "BD36F2167040D8E2",
    "3D872A22C2D77E20", "BDAC8859C4E5C0AF", "BDCDC583D118A561",
    "3E120F47CCF46B3C", "BE31A9E38DC84D60", "BE5F36CD6D3D46A9",
    "3E9C6B4F5D03B787", "BEB6E8A5434AE8A2", "BEED1D1F7B8736F6",
    "3F2879C2A212F024", "BF4845769484FCA8", "BF78B6C33114F909",
    "3FCEBD80D9B13E28", "3FFA755E7C99AE86"))
_ERFINV_W16 = tuple(_f64(h) for h in (
    "3E23040F87DBD932", "3E785CBE52878635", "BE92777453DD3955",
    "3E5395ABCD554C6C", "3EB936388A3790AD", "BED0D5DB812B5083",
    "3EC8860CD5D652F6", "3EEA29A0CACDFB23", "BF08CEF1F80281F2",
    "3F11E684D0B9188A", "3EF932CD54C8A222", "BF37448A89EF8AA3",
    "3F4F3CC55AD40C25", "BF5BA924132F38B1", "3F6468EECA533CF8",
    "BF6EBADABB891BBD", "3F75FFCFE5B76AFC", "3FF0158A6D641D39",
    "4008ABCC380D5A48"))
_ERFINV_WBIG = tuple(_f64(h) for h in (
    "BDBDCEC3A7785389", "BDF18FEEC0E38727", "3E19E6BF2DDA45E3",
    "BE30468FB24E2F5F", "3E405AC6A8FBA182", "BE50102E495FB9C0",
    "3E5F4C20E1334AF8", "BE722D220FDF9C3E", "3E8EBC8BB824CB54",
    "BEB0A8D40EA372CC", "3ED2FBD29D093D2B", "BEF4A3497E1E0FAC",
    "3F13EBF4EB00938F", "BF2C2F36A8FC5D53", "BF222EA5DF04047C",
    "3FF02A30D1FBA0DC", "4013664DDD1AD7FB"))
# float32: w < 5 and w >= 5 (9 coefficients each)
_ERFINV_F32_W5 = tuple(_f64(h) for h in (
    "3E5E2CB100000000", "3E970966C0000000", "BECD8E6AE0000000",
    "BED26B5820000000", "3F2CA65B60000000", "BF548A8100000000",
    "BF711C9DE0000000", "3FCF91EC60000000", "3FF805C5E0000000"))
_ERFINV_F32_WBIG = tuple(_f64(h) for h in (
    "BF2A3E1360000000", "3F1A76AD60000000", "3F561B8E40000000",
    "BF6E17BCE0000000", "3F77824F60000000", "BF7F38BAE0000000",
    "3F8354AFC0000000", "3FF006DB60000000", "4006A9EFC0000000"))


def _log1p_neg_square(x, fma, log, thresh, den_c, num_c):
    """XLA's ``log1p(-x * x)``: the rational for small ``|z|``, else
    ``log(1 + z)`` with the host's ``log``."""
    z = x * -x
    z2 = z * z
    z0 = z * 0.0
    den = z0 + 1.0
    for c in den_c:
        den = fma(den, z, c)
    num = z0 + num_c[0]
    for c in num_c[1:]:
        num = fma(num, z, c)
    small = z + fma(z2, -0.5, (z * z2) * (num / den))
    return torch.where(z.abs() < thresh, small, log(z + 1.0))


_ERFINV_TABLES: dict = {}


def _erfinv_table(sets, dtype, device) -> torch.Tensor:
    """The coefficient sets as one ``[len(sets), n]`` table on
    ``device`` (a shorter set padded with zeros at the end), so that
    Horner step ``i`` gathers column ``i`` by region."""
    key = (id(sets), dtype, device)
    t = _ERFINV_TABLES.get(key)
    if t is None:
        n = max(len(c) for c in sets)
        rows = [list(c) + [0.0] * (n - len(c)) for c in sets]
        t = _ERFINV_TABLES[key] = torch.tensor(rows, dtype=torch.float64
                                               ).to(dtype).to(device)
    return t


_ERFINV_F64_SETS = (_ERFINV_W6, _ERFINV_W16, _ERFINV_WBIG)
_ERFINV_F32_SETS = (_ERFINV_F32_W5, _ERFINV_F32_WBIG)


def erf_inv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float64 ``erf_inv``, bit for bit (``jax.random.normal``'s
    last step).  +-1 give +-inf."""
    if x.dtype != torch.float64:
        raise TypeError(f"erf_inv_f64 takes float64, got {x.dtype}")
    lg = _log1p_neg_square(x, fma_f64, log_f64, _L1P_THRESH_F64,
                           _L1P_DEN_F64, _L1P_NUM_F64)
    lt6 = lg > -6.25
    lt16 = lg > -16.0
    # region 0: w < 6.25, 1: w < 16, 2: w >= 16 (w = -lg)
    region = (~lt6).to(torch.int64) + (~lt16).to(torch.int64)
    shift = torch.where(lt16, 3.25, 5.0).to(x.dtype)
    t = torch.where(lt6, -3.125 - lg, sqrt_rn(-lg) - shift)
    tab = _erfinv_table(_ERFINV_F64_SETS, x.dtype, x.device)[region]
    # the shorter polynomials stop early: their lanes keep the value
    n6, n16, nbig = (len(c) for c in _ERFINV_F64_SETS)
    p = tab[..., 0]
    for i in range(1, n6):
        step = fma_f64(p, t, tab[..., i])
        p = (step if i < nbig else torch.where(lt16, step, p) if i < n16
             else torch.where(lt6, step, p))
    return x * torch.where(x.abs() == 1.0, torch.full_like(p, float("inf")),
                           p)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``erf_inv``, bit for bit.  +-1 give +-inf."""
    if x.dtype != torch.float32:
        raise TypeError(f"erf_inv_f32 takes float32, got {x.dtype}")
    lg = _log1p_neg_square(x, fma_f32, log_f32, _L1P_THRESH_F32,
                           _L1P_DEN_F32, _L1P_NUM_F32)
    lt5 = lg > -5.0
    t = torch.where(lt5, -2.5 - lg, sqrt_rn(-lg) + -3.0)
    tab = _erfinv_table(_ERFINV_F32_SETS, x.dtype, x.device)[
        (~lt5).to(torch.int64)]
    p = tab[..., 0]
    for i in range(1, tab.shape[-1]):
        p = fma_f32(p, t, tab[..., i])
    return x * torch.where(x.abs() == 1.0, torch.full_like(p, float("inf")),
                           p)
