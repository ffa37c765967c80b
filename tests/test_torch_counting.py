"""The PyTorch port's counting engine held against the JAX package.

The same seeded numpy inputs go through the reference's Pallas count
kernels (interpret mode, as tests/test_counting.py runs them on the CPU),
its scatter path and its bin+count kernel, and through the port's plain
versions (CPU tensors), the port's engine entry points and its chunked
fold.  Counts are integers, so every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from avenir_tpu.ops.counting import bin_raw as jax_bin_raw
from avenir_tpu.ops.counting import count_table as jax_count_table
from avenir_tpu.ops.counting import feature_class_counts as jax_fcc
from avenir_tpu.ops.pallas_count import (
    wide_feature_class_counts as jax_wide,
    wide_feature_class_counts_rawbin as jax_wide_rawbin)
from avenir_tpu.parallel.mesh import pad_rows as jax_pad_rows

from avenir_tpu_torch import convert
from avenir_tpu_torch.core import pipeline
from avenir_tpu_torch.device import pad_rows
from avenir_tpu_torch.ops import counting, histogram


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _codes(seed, n, F, C, B, dtype, masked):
    """Codes with -1 entries, bins >= B and classes outside [0, C)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, B + 2, (n, F)).astype(dtype)
    y = rng.integers(-1, C + 1, n).astype(dtype)
    mask = (rng.random(n) < 0.8) if masked else None
    return x, y, mask


@pytest.mark.parametrize("n,F,C,B,dtype,masked", [
    # n > the Pallas 4096-row block and not a multiple of it
    pytest.param(5000, 6, 4, 9, np.int32, True, id="ragged-masked-int32"),
    pytest.param(4500, 7, 2, 16, np.int8, False, id="churn-int8"),
    pytest.param(300, 3, 1, 1, np.int32, True, id="one-class-one-bin"),
])
def test_feature_class_counts_match_reference(n, F, C, B, dtype, masked):
    x, y, mask = _codes(11, n, F, C, B, dtype, masked)
    want = np.asarray(jax_wide(x, y, C, B, mask=mask, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jax_fcc(x, y, C, B, mask=mask, force_mxu=False)), want)
    got_k1 = histogram.wide_feature_class_counts(_t(x), _t(y), C, B,
                                                 mask=_t(mask))
    got_plain = histogram.plain_feature_class_counts(_t(x), _t(y), C, B,
                                                     _t(mask))
    got_engine = counting.feature_class_counts(_t(x), _t(y), C, B,
                                               mask=_t(mask))
    for got in (got_k1, got_plain, got_engine):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("n,widths,C,B,dtype,lo,hi,masked", [
    # tests/test_ingestcache.py's case: negative raws, width-1 passthrough,
    # a continuous (-1) column, masked rows
    pytest.param(1000, (1, 10, 1, 7, 100, 1), 3, 13, np.int32, -120, 120,
                 True, id="ingestcache-case"),
    pytest.param(4500, (1, 8, 8, 1, 2, 4, 1), 2, 16, np.int8, -40, 127,
                 False, id="churn-int8"),
])
def test_rawbin_counts_match_reference(n, widths, C, B, dtype, lo, hi,
                                       masked):
    rng = np.random.default_rng(3)
    F = len(widths)
    xraw = rng.integers(lo, hi, (n, F)).astype(dtype)
    xraw[:, 0] = rng.integers(0, 12, n)       # width-1 passthrough codes
    xraw[:, 2] = -1                           # continuous self-mask
    y = rng.integers(-1, C + 1, n).astype(dtype)
    mask = (rng.random(n) < 0.9) if masked else None
    np.testing.assert_array_equal(
        counting.bin_raw(_t(xraw), widths).numpy(),
        np.asarray(jax_bin_raw(xraw, widths)))
    want = np.asarray(jax_wide_rawbin(xraw, y, C, B, widths, mask=mask,
                                      interpret=True))
    got_k2 = histogram.wide_feature_class_counts_rawbin(
        _t(xraw), _t(y), C, B, widths, mask=_t(mask))
    got_plain = histogram.plain_feature_class_counts_rawbin(
        _t(xraw), _t(y), C, B, widths, _t(mask))
    got_engine = counting.feature_class_counts_rawbin(
        _t(xraw), _t(y), C, B, widths, mask=_t(mask))
    for got in (got_k2, got_plain, got_engine):
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("widths", [
    pytest.param((0, 1, 1), id="zero-width"),
    pytest.param((1, -3, 1), id="negative-width"),
    pytest.param((1, 1), id="wrong-length"),
])
@pytest.mark.parametrize("fn", [histogram.wide_feature_class_counts_rawbin,
                                counting.feature_class_counts_rawbin],
                         ids=["K2-wrapper", "engine"])
def test_rawbin_rejects_bad_widths(fn, widths):
    x = torch.zeros((4, 3), dtype=torch.int32)
    y = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        fn(x, y, 2, 4, widths)
    if len(widths) == 3:
        # the reference rejects widths < 1 the same way
        with pytest.raises(ValueError):
            jax_wide_rawbin(x.numpy(), y.numpy(), 2, 4, widths,
                            interpret=True)


def _bad_args():
    x = torch.zeros((5, 2), dtype=torch.int32)
    y = torch.zeros(5, dtype=torch.int8)
    return [
        pytest.param(dict(x=x.long()), TypeError, id="x-int64"),
        pytest.param(dict(y=y.float()), TypeError, id="y-float"),
        pytest.param(dict(mask=torch.ones(5, dtype=torch.int32)), TypeError,
                     id="mask-not-bool"),
        pytest.param(dict(x=torch.zeros((2, 5), dtype=torch.int32).t()),
                     ValueError, id="x-not-contiguous"),
        pytest.param(dict(y=torch.zeros(4, dtype=torch.int8)), ValueError,
                     id="y-wrong-length"),
        pytest.param(dict(x=torch.zeros(5, dtype=torch.int32)), ValueError,
                     id="x-1d"),
        pytest.param(dict(out=torch.zeros((2, 2, 3), dtype=torch.int32)),
                     ValueError, id="out-wrong-shape"),
        pytest.param(dict(out=torch.zeros((2, 2, 4), dtype=torch.int64)),
                     ValueError, id="out-wrong-dtype"),
        pytest.param(dict(n_class=0), ValueError, id="no-classes"),
    ]


@pytest.mark.parametrize("override,exc", _bad_args())
def test_wrapper_argument_checks(override, exc):
    args = dict(x=torch.zeros((5, 2), dtype=torch.int32),
                y=torch.zeros(5, dtype=torch.int8), n_class=2, max_bins=4,
                mask=None, out=None)
    args.update(override)
    with pytest.raises(exc):
        histogram.wide_feature_class_counts(
            args["x"], args["y"], args["n_class"], args["max_bins"],
            mask=args["mask"], out=args["out"])


def test_count_table_matches_reference():
    rng = np.random.default_rng(7)
    sizes = (3, 4, 5)
    idx = [rng.integers(-1, s + 1, 400) for s in sizes]
    w = rng.integers(0, 9, 400).astype(np.int32)
    mask = rng.random(400) < 0.7
    for weights in (None, w):
        want = np.asarray(jax_count_table(sizes, idx, weights=weights,
                                          mask=mask))
        got = counting.count_table(sizes, [_t(i) for i in idx],
                                   weights=_t(weights), mask=_t(mask))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [0, 2])
def test_streaming_fold_equals_one_shot_and_seeds_from_reference(depth):
    """Chunks folded on the device equal the reference's one-shot table,
    serially (depth 0) and with the prefetch worker (depth 2); a carry
    seeded with the reference's table of the first rows continues it."""
    n, F, C, B = 3000, 5, 3, 7
    x, y, _ = _codes(5, n, F, C, B, np.int8, False)
    want = np.asarray(jax_fcc(x, y, C, B, force_mxu=False))

    def local(xc, yc, mask, n_class, max_bins, out=None):
        return counting.feature_class_counts(xc, yc, n_class, max_bins,
                                             mask=mask, out=out)

    chunks = [(x[i:i + 700], y[i:i + 700]) for i in range(0, n, 700)]
    got = pipeline.streaming_fold(iter(chunks), local, static_args=(C, B),
                                  device=torch.device("cpu"),
                                  prefetch_depth=depth)
    np.testing.assert_array_equal(got, want)
    assert pipeline.streaming_fold(iter(()), local, static_args=(C, B),
                                   device=torch.device("cpu"),
                                   prefetch_depth=depth) is None

    head = np.asarray(jax_fcc(x[:1000], y[:1000], C, B, force_mxu=False))
    cf = pipeline.ChunkFold(local, static_args=(C, B),
                            device=torch.device("cpu"))
    cf.seed(head)
    carry = cf.carry
    transfer = pipeline.ChunkTransfer(torch.device("cpu"))
    dev = transfer((x[1000:], y[1000:]))
    assert dev[-1] is None          # unpadded chunks: every row valid
    cf.fold(dev)
    assert cf.carry is carry        # accumulated in place
    np.testing.assert_array_equal(cf.result(), want)
    np.testing.assert_array_equal(head, np.asarray(
        jax_fcc(x[:1000], y[:1000], C, B, force_mxu=False)))


def test_streaming_fold_relays_generator_errors():
    def chunks():
        yield (np.zeros((2, 1), np.int8), np.zeros(2, np.int8))
        raise KeyError("boom")

    def local(xc, yc, mask, out=None):
        return counting.feature_class_counts(xc, yc, 1, 1, out=out)

    with pytest.raises(KeyError):
        pipeline.streaming_fold(chunks(), local, device=torch.device("cpu"),
                                prefetch_depth=2)


def test_sharded_reduce_and_convert():
    x, y, _ = _codes(9, 600, 4, 2, 6, np.int32, False)
    want = np.asarray(jax_fcc(x, y, 2, 6, force_mxu=False))

    def local(xs, ys, mask, n_class, max_bins):
        assert mask is None
        return counting.feature_class_counts(xs, ys, n_class, max_bins)

    got = counting.sharded_reduce(local, x, y, device=torch.device("cpu"),
                                  static_args=(2, 6))
    np.testing.assert_array_equal(got.numpy(), want)
    t = convert.count_table_to_device(want, torch.device("cpu"))
    assert t.dtype == torch.int32
    t += 1                          # a copy: the source array is untouched
    np.testing.assert_array_equal(t.numpy() - 1, want)
    with pytest.raises(ValueError):
        convert.count_table_to_device(want[0], torch.device("cpu"))


@pytest.mark.parametrize("n,multiple", [(10, 1), (10, 4), (8, 4), (0, 3)])
def test_pad_rows_matches_reference(n, multiple):
    a = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
    got, gmask = pad_rows(a, multiple, fill=-1)
    want, wmask = jax_pad_rows(a, multiple, fill=-1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmask, wmask)
