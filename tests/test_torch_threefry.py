"""The port's threefry draws (``avenir_tpu_torch/ops/threefry.py``) and the
float math under them (``ops/xla_math.py``: FMA, glibc's float64 ``log``,
XLA's float32 ``exp`` and ``erf_inv``, the correctly rounded ``sqrt``)
held bit for bit against ``jax.random`` and ``jax.jit`` of the
elementwise functions, on the CPU, at several seeds, shapes and dtypes.
"""

import ctypes
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from avenir_tpu_torch.ops import threefry as tf
from avenir_tpu_torch.ops import xla_math as xm

SEEDS = (0, 41, 7, 2026, 2 ** 40 + 5)
FLOATS = ((torch.float32, jnp.float32), (torch.float64, jnp.float64))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def assert_bits(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        bad = (_bits(got) != _bits(want)) & ~(np.isnan(got) & np.isnan(want))
    else:
        bad = got.astype(np.uint64) != want.astype(np.uint64)
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} differ; first "
                           f"{got[bad][:4]} vs {want[bad][:4]}")


def _key(seed):
    return tf.prng_key(seed), jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_and_bits(seed):
    tk, jk = _key(seed)
    assert_bits(tk, np.asarray(jk).astype(np.int64))
    for data in (0, 12345, 2 ** 32 - 1):
        assert_bits(tf.fold_in(tk, data),
                    np.asarray(jax.random.fold_in(jk, data)).astype(np.int64))
    for num in (2, 5, (2, 3)):
        assert_bits(tf.split(tk, num),
                    np.asarray(jax.random.split(jk, num)).astype(np.int64))
    for shape in ((7, 3), (1,), ()):
        assert_bits(tf.random_bits(tk, 32, shape),
                    jax.random.bits(jk, shape, jnp.uint32))
    assert_bits(tf.random_bits(tk, 64, (11,)).numpy().view(np.uint64),
                jax.random.bits(jk, (11,), jnp.uint64))


def test_threefry2x32_block_on_random_counters():
    """The cipher itself on random key and counter words."""
    from jax._src import prng

    rng = np.random.default_rng(3)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x1, x2 = (rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    want = prng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                    jnp.asarray(x1), jnp.asarray(x2))
    got = tf.threefry2x32(int(k[0]), int(k[1]),
                          torch.from_numpy(x1.astype(np.int64)),
                          torch.from_numpy(x2.astype(np.int64)))
    for g, w in zip(got, want):
        assert_bits(g, w)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dt,jd", FLOATS)
def test_uniform_normal_gumbel(seed, dt, jd):
    tk, jk = _key(seed)
    assert_bits(tf.uniform(tk, (1000,), dt), jax.random.uniform(jk, (1000,), jd))
    assert_bits(tf.uniform(tk, (100,), dt, -3.5, 7.25),
                jax.random.uniform(jk, (100,), jd, -3.5, 7.25))
    assert_bits(tf.normal(tk, (5000,), dt), jax.random.normal(jk, (5000,), jd))
    assert_bits(tf.gumbel(tk, (500, 3), dt),
                jax.random.gumbel(jk, (500, 3), jd))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_and_categorical(seed):
    tk, jk = _key(seed)
    assert_bits(tf.randint(tk, (4096, 3), 0, 3),
                jax.random.randint(jk, (4096, 3), 0, 3))
    assert_bits(tf.randint(tk, (100,), -2, 9, torch.int32),
                jax.random.randint(jk, (100,), -2, 9, jnp.int32))
    rng = np.random.default_rng(seed % 1000)
    for dt, jd in FLOATS:
        lg = np.log(rng.dirichlet([1, 1, 1], 400)).astype(jd)
        assert_bits(tf.categorical(tk, torch.from_numpy(lg), axis=1),
                    jax.random.categorical(jk, lg, axis=1))


@pytest.mark.parametrize("dt,jd", FLOATS)
def test_thompson_draws_per_event(dt, jd):
    """The decide path's draws: ``normal(fold_in(PRNGKey(41), crc),
    (3,))`` per event (the streaming runbook's seed and arms), first the
    runbook's own event ids, then 10,000 random CRCs as one batch."""
    base = jax.random.PRNGKey(41)
    ids = [f"ev7-{i:05d}" for i in range(8)]
    crcs = np.array([zlib.crc32(e.encode()) for e in ids]
                    + list(np.random.default_rng(0).integers(
                        0, 2 ** 32, 10_000, dtype=np.uint64)), np.uint32)
    want = jax.jit(jax.vmap(lambda c: jax.random.normal(
        jax.random.fold_in(base, c), (3,), jd)))(crcs)
    keys = tf.fold_in(tf.prng_key(41), torch.from_numpy(crcs.astype(np.int64)))
    assert_bits(tf.normal(keys, (3,), dt), want)


# -- the float math ------------------------------------------------------------

def _libm():
    libm = ctypes.CDLL("libm.so.6")
    libm.fma.restype = ctypes.c_double
    libm.fma.argtypes = [ctypes.c_double] * 3
    return libm


def test_fma_f64_is_the_single_rounding_fma():
    rng = np.random.default_rng(5)
    n = 20_000
    a = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    b = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    # near-cancelling addends, where a double rounding would show
    c = -(a * b) * (1 + rng.standard_normal(n) * np.exp2(
        rng.integers(-60, 0, n)))
    c[::3] = rng.standard_normal(n)[::3]
    libm = _libm()
    want = np.array([libm.fma(x, y, z) for x, y, z in zip(a, b, c)])
    assert_bits(xm.fma_f64(*map(torch.from_numpy, (a, b, c))), want)


def test_log_f64_is_glibcs_log():
    """XLA's float64 ``log`` calls the host's libm; ``math.log`` is that
    same function, and ``jax.jit(jnp.log)`` is held too (away from the
    subnormals, which XLA flushes)."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.random(60_000), rng.random(20_000) * 0.2 + 0.9,
                        np.exp(rng.uniform(-700, 700, 20_000)),
                        [1.0, 2.0, 0.5, np.nextafter(1.0, 0.0),
                         np.nextafter(1.0, 2.0), 1e300]])
    got = xm.log_f64(torch.from_numpy(x))
    assert_bits(got, np.array([math.log(v) for v in x]))
    assert_bits(got, jax.jit(jnp.log)(x))
    edge = xm.log_f64(torch.tensor([0.0, -1.0, np.inf, np.nan],
                                   dtype=torch.float64)).numpy()
    assert edge[0] == -np.inf and np.isnan(edge[1]) and edge[2] == np.inf
    assert np.isnan(edge[3])


def test_exp_f32_is_xlas_exp():
    x = np.concatenate([np.random.default_rng(7).standard_normal(100_000)
                        * 20, [-88.0, -87.9, 0.0, 88.7, 89.0, 1e-30]]
                       ).astype(np.float32)
    assert_bits(xm.exp_f32(torch.from_numpy(x)), jax.jit(jnp.exp)(x))


@pytest.mark.parametrize("dt", (np.float64, np.float32))
def test_erf_inv_is_xlas_erf_inv(dt):
    """10^5 inputs in [-1, 1), more next to +-1 (the far polynomial and
    the ``log`` branch), and the edges, against ``jax.jit(lax.erf_inv)``."""
    rng = np.random.default_rng(8)
    one = dt(1.0)
    edge = np.array([np.nextafter(one, dt(0)), -np.nextafter(one, dt(0)),
                     0.0, 1.0, -1.0, 0.5, -0.999999, 1e-8,
                     np.nextafter(dt(-1.0), dt(0))], dt)
    near = (1 - rng.random(20_000).astype(dt) ** 8) * np.sign(
        rng.standard_normal(20_000)).astype(dt)
    x = np.concatenate([rng.uniform(-1, 1, 100_000).astype(dt), near, edge])
    fn = xm.erf_inv_f64 if dt == np.float64 else xm.erf_inv_f32
    assert_bits(fn(torch.from_numpy(x)), jax.jit(lax.erf_inv)(x))


@pytest.mark.parametrize("dt", (np.float64, np.float32))
def test_sqrt_rn_is_correctly_rounded(dt):
    """``torch.sqrt`` on the CPU misrounds about one input in a hundred;
    ``sqrt_rn`` must be the IEEE square root (numpy's, XLA's)."""
    x = np.random.default_rng(9).uniform(0, 50, 200_000).astype(dt)
    got = xm.sqrt_rn(torch.from_numpy(x))
    assert_bits(got, np.sqrt(x))
    assert_bits(got, jax.jit(jnp.sqrt)(x))
