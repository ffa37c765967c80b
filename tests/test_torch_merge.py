"""K3m, the merge of sorted key lists (``csrc/topk.cu`` ``merge_kernel``),
held on the CPU: its launch plan (``ops.topk.merge_plan``) over the shapes
its callers give it, the plan struct against the kernel source, the
kernel's schedule (staging rounds, the tree of pairwise merges in place,
ranks by binary search) replayed in numpy against the plain version, and
the merge's function against the reference's ``_lex_merge``
(avenir_tpu/ops/pallas_topk.py:402, a plain ``jax.lax.sort``).

Keys are ``(value << 32) | index``, sorted and unique within a row, with
``INT64_MAX`` in empty slots; every comparison is exact."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.ops.pallas_topk import _lex_merge

from avenir_tpu_torch.ops import topk

SENT64 = np.iinfo(np.int64).max
INT32_MAX = 2 ** 31 - 1
H100 = (132, 232_448)       # SMs, shared bytes a block may opt into


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _staged(plan, S):
    """The lists each staging round loads, as the kernel walks them."""
    rounds, nxt = [], 0
    for rnd in range(plan.rounds):
        first = 1 if rnd else 0
        n_load = min(plan.slots - first, S - nxt)
        rounds.append(range(nxt, nxt + n_load))
        nxt += n_load
    return rounds


@pytest.mark.parametrize("nq", [1, 8, 64, 512, 4096, 16384])
@pytest.mark.parametrize("k", [1, 16, 32, 33, 64])
@pytest.mark.parametrize("S", [1, 2, 3, 9, 99, 128, 257, 265, 600])
def test_merge_plan(S, k, nq):
    """Every row is owned by exactly one block (so the in-place keys-out
    form is safe), a block's shared memory fits, every list is staged in
    exactly one round and in order, and the grid is never empty."""
    plan = topk.merge_plan(S, nq, k, *H100)
    assert plan.grid >= 1
    assert plan.grid * plan.rows >= nq > (plan.grid - 1) * plan.rows
    assert plan.warps & (plan.warps - 1) == 0
    assert 1 <= plan.warps * plan.rows <= 32          # <= 1024 threads
    assert plan.smem == 8 * plan.rows * plan.slots * k <= H100[1]
    rounds = _staged(plan, S)
    assert all(len(r) >= 1 for r in rounds)
    assert [s for r in rounds for s in r] == list(range(S))
    assert plan.rounds == 1 or 2 <= plan.slots < S
    # one round wherever one row's lists fit a block
    assert (plan.rounds == 1) == (8 * S * k <= H100[1])


@pytest.mark.parametrize("S,nq,k,want", [
    # serving batches: 128 segment lists, a block of 32 warps a row
    (128, 1, 16, (32, 1, 128, 1, 16384, 1)),
    (128, 8, 16, (32, 1, 128, 1, 16384, 8)),
    (128, 64, 16, (32, 1, 128, 1, 16384, 64)),
    # a segmented ring hop: carry + 98 lists, 8 warps a row
    (99, 512, 16, (8, 1, 99, 1, 12672, 512)),
    # the kNN job, a ring hop at the kNN cell and the model axis: one warp
    # a row, 4 rows a block
    (3, 16384, 16, (1, 4, 3, 1, 1536, 4096)),
    (9, 4096, 16, (1, 4, 9, 1, 4608, 1024)),
    (12, 8192, 16, (1, 4, 12, 1, 6144, 2048)),
    (12, 16384, 16, (1, 4, 12, 1, 6144, 4096)),
    # K3's most segments on this card, in one round
    (257, 1, 64, (32, 1, 257, 1, 131584, 1)),
    (265, 1, 64, (32, 1, 265, 1, 135680, 1)),
    # a gather past one block: two rounds; a block cut to one row by its
    # lists keeps its four warps on that row
    (600, 1, 64, (32, 1, 454, 2, 232448, 1)),
    (600, 16384, 64, (4, 1, 454, 2, 232448, 16384)),
    (1, 1, 16, (1, 1, 1, 1, 128, 1)),
])
def test_merge_plan_at_the_callers_shapes(S, nq, k, want):
    assert tuple(topk.merge_plan(S, nq, k, *H100)) == want


def test_merge_plan_raises_where_two_lists_do_not_fit():
    with pytest.raises(ValueError):
        topk.merge_plan(4, 1, 64, 132, 1000)
    with pytest.raises(ValueError):
        topk.merge_plan(0, 1, 16, *H100)
    assert topk.merge_plan(1, 1, 64, 132, 512).slots == 1


def test_merge_plan_struct_matches_the_kernel_source():
    """``_MergePlan``'s fields are csrc/topk.cu's ``struct MergePlan``, in
    order (the launch reads the plan through that struct), and the
    kernel's ``MAX_K`` is the wrapper's."""
    src = (Path(topk.__file__).parent.parent / "csrc" / "topk.cu"
           ).read_text()
    body = re.search(r"struct MergePlan \{(.*?)\};", src, re.S).group(1)
    fields = [name for decl in body.split(";") if decl.strip()
              for name in re.sub(r"^\s*\w+\s+", "", decl).replace(
                  " ", "").split(",")]
    assert fields == [name for name, _ in topk._MergePlan._fields_]
    assert re.search(r"struct MergePlan \{\s*int32_t ", src)
    max_k = re.search(r"constexpr int MAX_K = (\d+);", src).group(1)
    assert int(max_k) == topk._MAX_K


# ---------------------------------------------------------------------------
# lists, and the kernel's schedule replayed
# ---------------------------------------------------------------------------

def _lists(S, nq, k, seed):
    """``[S, nq, k]`` sorted unique keys: values in [0, 5) so that values
    tie across lists, indices disjoint between lists, lists of 0 to k keys
    (some rows all empty)."""
    rng = np.random.default_rng(seed)
    keys = np.full((S, nq, k), SENT64, np.int64)
    empty_rows = rng.random(nq) < 0.05
    for s in range(S):
        n = rng.integers(0, k + 1, nq)
        n[empty_rows] = 0
        for r in range(nq):
            idx = rng.choice(10_000, n[r], replace=False) + 10_000 * s
            val = rng.integers(0, 5, n[r])
            keys[s, r, :n[r]] = np.sort((val.astype(np.int64) << 32) | idx)
    return keys


def _count_upto(lists, xl, k):
    """csrc/topk.cu::count_upto for each row: #(lists <= xl) over
    ``lists`` [rows, k] by the bit-lift binary search, a select per step."""
    n = np.zeros(len(xl), np.int64)
    step = 1 << (k.bit_length() - 1)
    while step:
        m = n + step
        y = np.take_along_axis(lists, np.minimum(m, k)[:, None] - 1, 1)[:, 0]
        n = np.where((m <= k) & (y <= xl), m, n)
        step >>= 1
    return n


def _replay(keys, plan):
    """``merge_kernel``'s schedule on the CPU, every row at once: the
    plan's staging rounds into ``slots``, then per level each pair's keys
    ranked by ``_count_upto`` against the other list (all reads before
    any write) and written in place into the pair's first slot.  Checks
    that every output position of a pair has exactly one writer."""
    S, nq, k = keys.shape
    slot = np.empty((plan.slots, nq, k), np.int64)
    rows = np.arange(nq)
    for rnd, lists in enumerate(_staged(plan, S)):
        first = 1 if rnd else 0
        slot[first:first + len(lists)] = keys[lists.start:lists.stop]
        n, stride = first + len(lists), 1
        while stride < n:
            for i in range(0, n - stride, 2 * stride):
                a, b = slot[i].copy(), slot[i + stride].copy()
                writes = np.zeros((nq, k), np.int64)
                for j in range(k):
                    # a_j: j + #(b < a_j); b_j: j + #(a <= b_j)
                    for x, at in ((a[:, j],
                                   j + _count_upto(b, a[:, j] - 1, k)),
                                  (b[:, j], j + _count_upto(a, b[:, j], k))):
                        hit = at < k
                        slot[i, rows[hit], at[hit]] = x[hit]
                        writes[rows[hit], at[hit]] += 1
                assert (writes == 1).all()
            stride *= 2
    return slot[0]


@pytest.mark.parametrize("S,nq,k,smem", [
    (1, 5, 16, H100[1]),
    (2, 7, 1, H100[1]),
    (3, 333, 16, H100[1]),
    (12, 40, 33, H100[1]),
    (99, 9, 16, H100[1]),
    (128, 3, 16, H100[1]),
    (257, 2, 64, H100[1]),
    (21, 6, 16, 4 * 128),       # 4 slots: rounds of 4, 3, 3, ...
    (10, 4, 64, 2 * 512),       # 2 slots: a running list and one more
    (37, 5, 7, 5 * 56),
])
def test_merge_schedule_replay_equals_the_plain_version(S, nq, k, smem):
    """The kernel's algorithm at the plan's schedule (rounds forced by a
    small shared budget in the last three cases) keeps exactly the k
    smallest keys of each row, empty slots last."""
    keys = _lists(S, nq, k, seed=S * 1000 + k)
    plan = topk.merge_plan(S, nq, k, 132, smem)
    assert (plan.rounds == 1) == (smem == H100[1])
    want = topk.plain_merge_topk_keys(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(_replay(keys, plan), want)
    flat = np.sort(keys.transpose(1, 0, 2).reshape(nq, -1), axis=1)[:, :k]
    np.testing.assert_array_equal(want, flat)


# ---------------------------------------------------------------------------
# the function, against the reference
# ---------------------------------------------------------------------------

def _reference(keys):
    """``_lex_merge`` over the lists laid side by side as the reference
    lays its segments and shards: int32 values (INT32_MAX in empty slots)
    and indices (-1), sorted on both keys."""
    S, nq, k = keys.shape
    flat = keys.transpose(1, 0, 2).reshape(nq, S * k)
    empty = flat == SENT64
    v = np.where(empty, INT32_MAX, flat >> 32).astype(np.int32)
    i = np.where(empty, -1, flat & 0xFFFFFFFF).astype(np.int32)
    rv, ri = _lex_merge(jnp.asarray(v), jnp.asarray(i), k)
    return np.asarray(rv), np.asarray(ri)


@pytest.mark.parametrize("k", [1, 16, 33, 64])
@pytest.mark.parametrize("S,nq", [
    (1, 9),             # one segment: a copy
    (3, 333),           # the kNN job's segments
    (128, 1),           # serving batches' segments
    (128, 8),
    (128, 64),
    (99, 512),          # a segmented ring hop: carry + 98
])
def test_merge_matches_reference(S, nq, k):
    """``plain_merge_topk``, ``merge_topk_lists`` and ``merge_topk_keys``
    (in place into list 0, with each row's k-th value) on CPU tensors give
    the reference's ``_lex_merge``, values and indices exactly, with ties
    in value across lists and short or empty lists."""
    keys = _lists(S, nq, k, seed=7 * S + nq + k)
    rv, ri = _reference(keys)
    t = torch.from_numpy(keys)
    for v, i in (topk.plain_merge_topk(t), topk.merge_topk_lists(t)):
        np.testing.assert_array_equal(v.numpy(), rv)
        np.testing.assert_array_equal(i.numpy(), ri)
    inplace = t.clone()
    kth = torch.empty(nq, dtype=torch.int32)
    out = topk.merge_topk_keys(inplace, inplace[0], kth)
    assert out.data_ptr() == inplace.data_ptr()
    v, i = topk.split_keys(inplace[0])
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(kth.numpy(), rv[:, k - 1])
    assert torch.equal(inplace[1:], t[1:])          # the other lists stay
