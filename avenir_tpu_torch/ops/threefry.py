"""jax 0.9's threefry PRNG, bit for bit, in plain PyTorch.

The JAX package draws its random numbers with ``jax.random`` under
``jax_threefry_partitionable = True`` (the default since jax 0.5).  This
module reproduces those draws from the integers up, so that a decision
or a learner step that the reference takes with a key takes the same
value here, on the CPU and on a CUDA card alike:

- :func:`threefry2x32` is the Threefry-2x32 block cipher with 20 rounds,
  the rotations and the key schedule of ``jax/_src/prng.py``;
- a key is an int64 tensor ``[..., 2]`` holding two 32-bit words
  (:func:`prng_key` builds one from a seed, as ``jax.random.PRNGKey``);
- :func:`fold_in`, :func:`split` and :func:`random_bits` are the
  partitionable forms (``_threefry_split_foldlike``,
  ``_threefry_random_bits_partitionable``), whose counters are the 64-bit
  iota of the output shape split into two 32-bit words;
- :func:`uniform`, :func:`normal`, :func:`randint`, :func:`gumbel` and
  :func:`categorical` follow ``jax/_src/random.py`` step by step, with
  XLA CPU's float math (``ops.xla_math``) where they call ``erf_inv`` or
  ``log``.

Every batched key (a ``[B, 2]`` tensor) draws as ``jax.vmap`` of the
one-key function would.  Torch has no full ``uint32`` arithmetic, so the
words live in int64 tensors and every add and rotation is masked back to
32 bits.  Each step is one eager op, rounded once: keep this module out
of ``torch.compile`` and out of fused kernels, which may contract a
multiply and an add and change the bits.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .xla_math import (erf_inv_f32, erf_inv_f64, fma_f32, fma_f64,
                       log_f32, log_f64)

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x1, x2)`` under the key
    words ``(k1, k2)``: int64 tensors (or ints) holding values in
    ``[0, 2**32)``, broadcast against each other.  Returns the two
    output words, as ``threefry2x32_p``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under x64: the seed's 64 bits as
    ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    # two fills, no copy from the host: a CUDA graph can capture them
    key = torch.empty(2, dtype=torch.int64, device=device)
    key[:1].fill_(s >> 32)
    key[1:].fill_(s & _MASK)
    return key


def _words(key: torch.Tensor):
    return key[..., 0:1], key[..., 1:2]


def _iota_2x32(key: torch.Tensor, shape: Tuple[int, ...]):
    """The counters of ``shape``: the row-major 64-bit iota, split into
    high and low 32-bit words, laid after the key's batch axes."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return idx >> 32, idx & _MASK


def _hash(key: torch.Tensor, shape: Tuple[int, ...]):
    """``threefry2x32(key, iota_2x32_shape(shape))`` for a key ``[...,
    2]``: two word tensors ``[..., *shape]``."""
    hi, lo = _iota_2x32(key, shape)
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    batch = key.shape[:-1]
    out = tuple(batch) + shape
    return b1.reshape(out), b2.reshape(out)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))``, the data
    taken as uint32.  ``data`` may be an int or a tensor, which broadcasts
    against the key's batch axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data & _MASK)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., *num, 2]``."""
    b1, b2 = _hash(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int,
                shape: Shape) -> torch.Tensor:
    """``jax.random.bits``: 32-bit draws as int64 values in ``[0,
    2**32)`` (``bits1 ^ bits2``), 64-bit draws as int64 tensors holding
    the uint64 bits ``bits1 << 32 | bits2``."""
    b1, b2 = _hash(key, _shape(shape))
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        hi = torch.where(b1 >= 1 << 31, b1 - (1 << 32), b1)
        return hi * (1 << 32) + b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


_FLOAT = {torch.float32: (32, 23, torch.int32, 0x3F800000),
          torch.float64: (64, 52, torch.int64, 0x3FF0000000000000)}


def uniform(key: torch.Tensor, shape: Shape = (),
            dtype: torch.dtype = torch.float64, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: random mantissa bits under exponent 0 give
    ``[1, 2)``, less 1, scaled by ``maxval - minval`` (taken in
    ``dtype``) and shifted by ``minval`` in one FMA (XLA contracts the
    two), then clamped below at ``minval``."""
    nbits, nmant, itype, one = _FLOAT[dtype]
    bits = random_bits(key, nbits, shape)
    keep = (1 << nmant) - 1
    fbits = ((bits >> (nbits - nmant)) & keep) | one
    floats = fbits.to(itype).view(dtype) - 1.0
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = npd(minval), npd(maxval)
    fma = fma_f32 if dtype == torch.float32 else fma_f64
    return torch.clamp_min(fma(floats, float(hi - lo), float(lo)),
                           float(lo))


def normal(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` for ``u`` uniform
    on ``[nextafter(-1, 0), 1)``, with XLA's ``erf_inv``."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    erf_inv = erf_inv_f32 if dtype == torch.float32 else erf_inv_f64
    return float(npd(np.sqrt(2))) * erf_inv(u)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``jax.random.randint``: two keys, two draws of the dtype's width,
    combined modulo the span as ``((hi % span) * (2**nbits % span) + lo
    % span) % span``.  Spans below 2**16 (arm counts)."""
    nbits = {torch.int32: 32, torch.int64: 64}[dtype]
    span = int(maxval) - int(minval) if maxval > minval else 1
    if span >= 1 << 16:
        raise ValueError(f"randint spans up to 2**16 here, got {span}")
    k1, k2 = split(key).unbind(-2)
    hi, lo = random_bits(k1, nbits, shape), random_bits(k2, nbits, shape)
    mult = (pow(2, nbits // 2, span) ** 2) % span
    if nbits == 64:
        # the uint64 draws, reduced modulo span through their two words
        word = (1 << 32) % span

        def rem(b):
            top = (b >> 32) & _MASK
            return ((top % span) * word + (b & _MASK) % span) % span
        hi, lo = rem(hi), rem(lo)
    off = ((hi % span) * mult + lo % span) % span
    return (int(minval) + off).to(dtype)


def gumbel(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``low``): ``-log(-log(u))`` for ``u``
    uniform on ``[tiny, 1)``, with XLA's ``log``."""
    tiny = float(torch.finfo(dtype).tiny)
    log = log_f32 if dtype == torch.float32 else log_f64
    return -log(-log(uniform(key, shape, dtype, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the argmax of gumbel
    noise plus the logits along ``axis`` (ties to the lowest index)."""
    g = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=axis)
