"""The histogram kernels' host side, held on the CPU: the launch plan of
``csrc/histogram.cu`` (route by table size, cluster sizes, grid), K2's
reciprocal binning replayed step by step against ``bin_raw``, and the one
place where the port's K2 departs from the reference's device binning on
purpose (INT32_MIN, where the reference wraps and Java does not)."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.ops.counting import feature_class_counts as jax_fcc
from avenir_tpu.ops.pallas_count import (
    wide_feature_class_counts_rawbin as jax_wide_rawbin)

from avenir_tpu_torch.ops import histogram
from avenir_tpu_torch.ops.counting import bin_raw

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

# (sms, shared bytes a block may opt into, shared bytes an SM has)
H100 = (132, 232448, 233472)
CARDS = {"H100": H100, "A100": (108, 166912, 167936),
         "small": (20, 48 * 1024, 64 * 1024)}


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _assert_plan(plan, n, F, C, B, x_bytes, card, rawbin):
    sms, per_block, per_sm = card
    cells = C * F * B
    route = histogram.ROUTES[plan.route]
    assert plan.smem <= per_block
    assert 1 <= plan.cluster <= 8
    # never an empty grid; whole clusters; no more blocks than can be
    # resident unless one cluster needs them
    assert plan.grid >= 1 and plan.grid % plan.cluster == 0
    assert plan.grid <= max(plan.cluster, sms * histogram.BLOCKS_PER_SM)
    # each thread counts at least a tile's share where n*F allows
    per_thread = histogram.TILE_ELEMS[x_bytes] // histogram.THREADS
    assert plan.grid == plan.cluster or \
        n * F / (plan.grid * histogram.THREADS) >= per_thread
    # the shared layout the kernel reads: (w, m) pairs, tile / F + 3
    # staged row offsets, the route's table cells
    assert plan.tile == histogram.TILE_ELEMS[x_bytes]
    assert plan.stage % 16 == 0 and plan.stage >= (8 * F if rawbin else 0)
    assert plan.table - plan.stage >= 4 * (plan.tile // F + 3)
    assert plan.smem - plan.table == {"block table": 4 * (cells + 1),
                                      "cluster": 4 * plan.slice,
                                      "global": 0}[route]
    room = (per_block - plan.table) // 4    # cells one block can hold
    if route == "block table":
        assert plan.cluster == 1 and plan.slice == 0
        assert cells + 1 <= room
    elif route == "cluster":
        assert cells + 1 > room             # no block holds it alone
        assert plan.cluster == histogram.CLUSTER and plan.slice <= room
        assert plan.slice * plan.cluster >= cells
        assert plan.slice * (plan.cluster - 1) < cells   # no empty slice
    else:
        assert plan.cluster == 1 and plan.slice == 0
        assert cells > histogram.CLUSTER * room   # no pair holds it
    return route


SHAPES = [
    # (n, F, C, B, x_bytes): the main path's chunks, churn, wide, the
    # 256 KB and 2 MB tables of chip_smoke.py, and small or odd ones
    (131_072, 6, 2, 16, 1), (131_072, 6, 2, 16, 4), (1_600_000, 6, 2, 16, 1),
    (2_000_000, 32, 8, 32, 4), (262_144, 64, 8, 128, 4),
    (262_144, 64, 8, 1024, 4), (1, 6, 2, 16, 1), (0, 3, 1, 1, 4),
    (7, 1, 1, 1, 1), (4099, 1, 3, 5, 1), (10 ** 6, 1, 1, 60_000, 4),
    (10 ** 5, 500, 10, 100, 1), (50_000, 13, 7, 1000, 4),
]


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("rawbin", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_histogram_plan(shape, rawbin, card):
    n, F, C, B, x_bytes = shape
    plan = histogram.histogram_plan(n, F, C, B, x_bytes, *CARDS[card],
                                    rawbin=rawbin)
    _assert_plan(plan, n, F, C, B, x_bytes, CARDS[card], rawbin)


@pytest.mark.parametrize("card", sorted(CARDS))
def test_histogram_plan_routes_grow_with_the_table(card):
    """Every route in order as the table grows, and never back."""
    routes = [histogram.histogram_plan(10 ** 6, 16, 1, B, 4,
                                       *CARDS[card]).route
              for B in range(1, 20_000, 97)]
    assert routes == sorted(routes)
    assert set(routes) == set(range(len(histogram.ROUTES)))


@pytest.mark.parametrize("shape,route,cluster", [
    ((131_072, 6, 2, 16, 1), "block table", 1),      # main path, cold chunk
    ((131_072, 6, 2, 16, 4), "block table", 1),      # main path, warm chunk
    ((2_000_000, 32, 8, 32, 4), "block table", 1),   # wide, 32 KB
    ((262_144, 64, 8, 128, 4), "cluster", 2),        # 256 KB
    ((262_144, 64, 8, 1024, 4), "global", 1),        # 2 MB
])
def test_histogram_plan_on_the_h100(shape, route, cluster):
    plan = histogram.histogram_plan(*shape, *H100)
    assert (histogram.ROUTES[plan.route], plan.cluster) == (route, cluster)


# the tables of the forced-route probe (histogram_probe.py --routes)
TABLE_256K, TABLE_1800K = (1 << 18, 64, 8, 128, 4), (1 << 18, 64, 8, 900, 4)


@pytest.mark.parametrize("shape,route,cluster,fits", [
    (TABLE_256K, 1, 2, True), (TABLE_256K, 1, 4, True),
    (TABLE_256K, 1, 8, True), (TABLE_256K, 2, 2, True),
    (TABLE_256K, 0, 2, False), (TABLE_256K, 1, 1, False),
    (TABLE_256K, 1, 16, False), (TABLE_1800K, 1, 8, True),
    (TABLE_1800K, 1, 4, False), (TABLE_1800K, 2, 2, True),
])
def test_histogram_plan_forced_route(shape, route, cluster, fits):
    """A forced route and cluster size is planned where it fits, with the
    layout and grid of an automatic plan, and raises where it does not."""
    if not fits:
        with pytest.raises(ValueError):
            histogram.histogram_plan(*shape, *H100, route=route,
                                     cluster=cluster)
        return
    plan = histogram.histogram_plan(*shape, *H100, route=route,
                                    cluster=cluster)
    n, F, C, B, _ = shape
    assert plan.route == route
    assert plan.cluster == (cluster if route == 1 else 1)
    assert plan.grid % plan.cluster == 0 and plan.grid >= plan.cluster
    assert plan.smem <= H100[1]
    assert plan.slice * plan.cluster >= C * F * B if route == 1 else \
        plan.slice == 0


def test_plan_struct_matches_the_kernel_source():
    """``_Plan``'s fields are csrc/histogram.cu's ``struct Plan``, in order:
    the launch reads the plan through that struct."""
    src = (Path(histogram.__file__).parent.parent / "csrc"
           / "histogram.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = [name for decl in body.split(";") if decl.strip()
              for name in re.sub(r"^\s*\w+\s+", "", decl).replace(
                  " ", "").split(",")]
    assert fields == [name for name, _ in histogram._Plan._fields_]


def test_histogram_plan_raises_where_the_stage_does_not_fit():
    with pytest.raises(ValueError):
        histogram.histogram_plan(10, 40_000, 1, 1, 4, *CARDS["small"],
                                 rawbin=True)


# ---------------------------------------------------------------------------
# K2's reciprocal binning
# ---------------------------------------------------------------------------

def _replay(x: torch.Tensor, w: int, m: int) -> torch.Tensor:
    """csrc/histogram.cu::bin_of step by step: q = umulhi(|x|, m), one
    increment where |x| - q*w >= w, the sign put back (int64 holds every
    product: |x| <= 2^31 and m < 2^32)."""
    a = x.to(torch.int64).abs()
    q = (a * m) >> 32
    q = q + (a - q * w >= w).to(torch.int64)
    return torch.where(x < 0, -q, q).to(torch.int32)


def _values(w: int, seed: int) -> torch.Tensor:
    edges = [0, 1, -1, w - 1, -(w - 1), w, -w, w + 1, -(w + 1), INT32_MIN,
             INT32_MAX, INT32_MIN + 1, 2 * w - 1, -(2 * w - 1)]
    edges = [v for v in edges if INT32_MIN <= v <= INT32_MAX]
    rand = np.random.default_rng(seed).integers(INT32_MIN, INT32_MAX,
                                                100_000, endpoint=True)
    return torch.from_numpy(np.concatenate([np.asarray(edges, np.int64),
                                            rand]).astype(np.int32))


_rng = np.random.default_rng(4)
WIDTHS = ([1, 2, 3, 7, 100, 200, INT32_MAX] + [2 ** k for k in range(2, 31)]
          + [int(w) for w in _rng.integers(1, INT32_MAX, 6)]
          + [int(w) for w in _rng.integers(1, 5000, 6)])


@pytest.mark.parametrize("w", WIDTHS)
def test_k2_quotient_equals_bin_raw(w):
    ((w_, m),) = histogram.k2_constants((w,))
    assert w_ == w and m == 0xFFFFFFFF // w
    x = _values(w, w % 1000)
    want = bin_raw(x[:, None], [w])[:, 0]
    assert torch.equal(_replay(x, w, m), want)
    if w == 1:
        assert torch.equal(want, x)          # width 1 passes through


@settings(max_examples=300, deadline=None)
@given(st.integers(INT32_MIN, INT32_MAX), st.integers(1, INT32_MAX))
def test_k2_quotient_is_java_truncation(x, w):
    ((_, m),) = histogram.k2_constants((w,))
    java = abs(x) // w * (1 if x >= 0 else -1)
    got = _replay(torch.tensor([x], dtype=torch.int32), w, m)
    assert int(got[0]) == java


@pytest.mark.parametrize("widths", [(0,), (-1,), (2 ** 31,), (1, 0, 1)])
def test_k2_constants_reject_bad_widths(widths):
    with pytest.raises(ValueError):
        histogram.k2_constants(widths)


# ---------------------------------------------------------------------------
# INT32_MIN: the reference's device binning wraps, Java's does not
# ---------------------------------------------------------------------------

def test_k2_at_int32_min_follows_java_not_the_reference_device_path():
    """At INT32_MIN and w = 2^30 Java truncation gives bin -2, which adds
    nothing; the reference's own host binning (core/binning.py, int64)
    agrees.  The reference's device binning negates in int32, wraps, and
    counts the row at bin 2 (pallas_count.py:81, ops/counting.py:201).
    The port keeps Java's answer."""
    w, C, B = 2 ** 30, 2, 4
    raws = [INT32_MIN, -5, -(w + 3), w + 7, 0, INT32_MAX]
    schema = JaxSchema.from_json(json.dumps({"fields": [
        {"name": "v", "ordinal": 0, "dataType": "int", "feature": True,
         "min": 0, "max": INT32_MAX, "bucketWidth": w},
        {"name": "c", "ordinal": 1, "dataType": "categorical",
         "cardinality": ["A", "B"]}]}))
    classes = ["A", "B", "A", "B", "A", "B"]
    ds = JaxEncoder(schema).encode([[str(v), c] for v, c in
                                    zip(raws, classes)])
    # the encoder's own bins, before it shifts negative ones to zero
    host_bins = ds.x + ds.bin_offset[None, :]
    assert host_bins[0, 0] == -2
    host_then_k1 = np.asarray(jax_fcc(host_bins, ds.y, C, B,
                                      force_mxu=False))

    xraw = np.asarray(raws, np.int32)[:, None]
    y = ds.y.astype(np.int32)
    port = histogram.wide_feature_class_counts_rawbin(
        torch.from_numpy(xraw), torch.from_numpy(y), C, B, (w,))
    np.testing.assert_array_equal(port.numpy(), host_then_k1)
    assert host_then_k1[0, 0, 2] == 0          # INT32_MIN adds nothing

    reference_device = np.asarray(jax_wide_rawbin(xraw, y, C, B, (w,),
                                                  interpret=True))
    assert reference_device[0, 0, 2] == host_then_k1[0, 0, 2] + 1
    assert not np.array_equal(reference_device, host_then_k1)
