"""The port's distance engine and kernel K3's plain version held against
the JAX package on the CPU.

Shapes and seeds are those of tests/test_pallas_topk.py and
tests/test_knn.py.  The JAX side runs both of its exact engines as its
own tests run them: the sorted engine, and the fused Pallas kernel in
interpret mode on a one-device mesh.

The engines' parity cases (``test_engines_match_reference``) take the
reference's answers from a fresh interpreter (``reference_answers``), set
up as tests/conftest.py sets up this one: the answer the port is held to
cannot depend on what earlier tests left in this process's JAX runtime.

Tolerance: the reference's own kNN contract (ops/distance.py:454-458).
Two implementations compute the float32 cross term in different orders,
so a distance that lands on an int-scale rounding boundary may differ by
one unit; every row whose values or indices differ must be confirmed by a
float64 oracle (both index sets carry the oracle's k smallest distances
within one unit), and such rows stay rare.  Where the inputs are
integer-valued every sum is exact and the results must be equal.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avenir_tpu.ops import pallas_topk as jpt
from avenir_tpu.ops.distance import pairwise_distances as jax_pairwise
from avenir_tpu.ops.distance import topk_smallest as jax_topk_smallest

from avenir_tpu_torch.ops import distance, topk
from avenir_tpu_torch.ops.distance import pairwise_distances

L = jpt._L


def _rand(nq, nt, F, C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (nq, F)).astype(np.float32),
            rng.integers(0, 4, (nq, C)).astype(np.int32),
            rng.uniform(0, 1, (nt, F)).astype(np.float32),
            rng.integers(0, 4, (nt, C)).astype(np.int32),
            rng.uniform(0.5, 2.0, F),
            rng.uniform(0.5, 2.0, C))


def _oracle(qn, qc, tn, tc, nw, cw, algorithm, scale=1000):
    """Float64 int-scaled distances [nq, nt]."""
    q, t = qn.astype(np.float64), tn.astype(np.float64)
    if algorithm == "euclidean":
        num = (nw[None, None, :] * (q[:, None, :] - t[None, :, :]) ** 2).sum(2)
    else:
        num = (nw[None, None, :] * np.abs(q[:, None, :] - t[None, :, :])).sum(2)
    cat = (cw[None, None, :] * (qc[:, None, :] != tc[None, :, :])).sum(2)
    d = (num + cat) / (float(nw.sum() + cw.sum()) or 1.0)
    if algorithm == "euclidean":
        d = np.sqrt(d)
    return (d * scale).astype(np.int64)


def _agree(got, want, operands, algorithm="euclidean", exact=False):
    """The reference's kNN tolerance between two (values, indices)
    selections of the same rows."""
    (gv, gi), (wv, wi) = got, want
    if exact:
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gi, wi)
        return
    assert np.abs(gv.astype(np.int64) - wv).max(initial=0) <= 1
    rows = np.flatnonzero((gv != wv).any(1) | (gi != wi).any(1))
    if not rows.size:
        return
    qn, qc, tn, tc, nw, cw = operands
    d = _oracle(qn[rows], qc[rows], tn, tc, nw, cw, algorithm)
    k = gv.shape[1]
    best = np.sort(d, axis=1)[:, :k]
    ok = np.array([[np.abs(np.sort(d[j, idx[rows[j]]]) - best[j]).max() <= 1
                    for idx in (gi, wi)] for j in range(rows.size)])
    # which side the oracle confirms, so a failure names the side that
    # moved
    assert rows.size <= max(1, len(gv) // 100), (
        f"{rows.size} rows differ ({rows.tolist()}); oracle-confirmed: "
        f"got {int(ok[:, 0].sum())}, want {int(ok[:, 1].sum())}")
    assert ok.all(), f"rows {rows[~ok.all(1)].tolist()} fail the oracle"


def _both_jax(operands, k, mesh1, algorithm="euclidean", fused=True):
    out = [jax_pairwise(*operands, top_k=k, mesh=mesh1,
                        topk_method="sorted", algorithm=algorithm)]
    if fused:
        out.append(jax_pairwise(*operands, top_k=k, mesh=mesh1,
                                topk_method="fused", algorithm=algorithm))
    return out


def _port(operands, k, method, algorithm="euclidean", stats=None):
    return pairwise_distances(*operands, top_k=k, device="cpu",
                              topk_method=method, algorithm=algorithm,
                              stats=stats)


def _repeat_candidates(ops, times):
    qn, qc, tn, tc, nw, cw = ops
    return qn, qc, np.repeat(tn, times, 0), np.repeat(tc, times, 0), nw, cw


def _categorical_only(ops):
    qn, qc, tn, tc, nw, cw = ops
    return (np.zeros((len(qn), 0), np.float32), qc,
            np.zeros((len(tn), 0), np.float32), tc, np.zeros(0), cw)


def _integer_valued(ops):
    qn, qc, tn, tc, nw, cw = ops
    return ((qn * 8).round(), qc, (tn * 8).round(), tc, np.ones(nw.shape),
            np.ones(cw.shape))


# name: (operands, k, algorithm, exact, also run the JAX fused engine)
CASES = {
    "mixed": (lambda: _rand(333, 1111, 7, 3), 9, "euclidean", False, False),
    "single-device": (lambda: _rand(64, 700, 5, 2, seed=3), 5, "euclidean",
                      False, True),
    "ties": (lambda: _repeat_candidates(_rand(50, 200, 4, 2, seed=1), 6), 8,
             "euclidean", False, True),
    "pure-categorical": (lambda: _categorical_only(_rand(64, 2048, 0, 4,
                                                         seed=2)),
                         5, "euclidean", True, False),
    "k-above-16": (lambda: _rand(32, 2600, 5, 0, seed=15), 40, "euclidean",
                   False, True),
    "manhattan": (lambda: _rand(90, 1111, 6, 2, seed=21), 7, "manhattan",
                  False, True),
    "manhattan-pure-categorical": (
        lambda: _categorical_only(_rand(24, 300, 0, 3, seed=22)), 5,
        "manhattan", True, False),
    "integer-valued": (lambda: _integer_valued(_rand(40, 900, 6, 2, seed=30)),
                       12, "euclidean", True, False),
}


# Answers computed in a fresh interpreter set up as tests/conftest.py sets
# up this one (8 virtual CPU devices, x64, the one-device mesh).  argv[1]
# is the .npz to write; argv[3] is "reference" (the JAX package's answers
# to every case of CASES) or "port:<case>:<method>" (the port's answer to
# one case).
_FRESH_SCRIPT = """
import os, sys
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax
jax.config.update("jax_platforms", "cpu")
import avenir_tpu
avenir_tpu.enable_x64()
import numpy as np
from avenir_tpu.parallel import make_mesh
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[2])))
import test_torch_distance as t
out = {}
if sys.argv[3] == "reference":
    mesh1 = make_mesh(devices=jax.devices()[:1])
    for name, (make, k, algorithm, exact, jax_fused) in t.CASES.items():
        refs = t._both_jax(make(), k, mesh1, algorithm, fused=jax_fused)
        for i, (v, idx) in enumerate(refs):
            out[f"{name}/{i}/v"] = np.asarray(v)
            out[f"{name}/{i}/i"] = np.asarray(idx)
else:
    _, name, method = sys.argv[3].split(":")
    make, k, algorithm, _, _ = t.CASES[name]
    v, idx = t._port(make(), k, method, algorithm)
    out["v"], out["i"] = np.asarray(v), np.asarray(idx)
np.savez(sys.argv[1], **out)
"""


def _fresh(out_dir, mode):
    """Run ``_FRESH_SCRIPT`` in ``mode``; returns its arrays."""
    out = os.path.join(str(out_dir), mode.replace(":", "_") + ".npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    run = subprocess.run([sys.executable, "-c", _FRESH_SCRIPT, out,
                          os.path.abspath(__file__), mode],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr
    return np.load(out)


@pytest.fixture(scope="module")
def reference_answers(tmp_path_factory):
    """``{case: [(values, indices), ...]}``: the JAX package's sorted
    engine (and its fused engine where the case runs it) on every case
    of CASES, from a fresh interpreter."""
    z = _fresh(tmp_path_factory.mktemp("reference"), "reference")
    answers = {}
    for name in CASES:
        n = sum(1 for key in z.files if key.startswith(f"{name}/")) // 2
        answers[name] = [(z[f"{name}/{i}/v"], z[f"{name}/{i}/i"])
                         for i in range(n)]
    return answers


def _moved(a, b):
    """How many rows of two (values, indices) answers differ."""
    return int(((a[0] != b[0]).any(1) | (a[1] != b[1]).any(1)).sum())


def _which_side_moved(name, method, got, refs, ops, mesh1, tmp_dir):
    """For a failed parity case: the port's answer recomputed in a fresh
    interpreter and the reference's recomputed in this one, each held
    against the answer the case used."""
    make, k, algorithm, _, jax_fused = CASES[name]
    z = _fresh(tmp_dir, f"port:{name}:{method}")
    port_rows = _moved((np.asarray(got[0]), np.asarray(got[1])),
                       (z["v"], z["i"]))
    here = _both_jax(ops, k, mesh1, algorithm, fused=jax_fused)
    ref_rows = [_moved((np.asarray(v), np.asarray(i)), ref)
                for (v, i), ref in zip(here, refs)]
    return (f"port {method}: {port_rows} rows differ from a fresh "
            f"interpreter's answer; reference (this process against a fresh "
            f"interpreter): {ref_rows} rows differ")


@pytest.mark.parametrize("name", list(CASES))
def test_engines_match_reference(name, reference_answers, mesh1, tmp_path):
    make, k, algorithm, exact, jax_fused = CASES[name]
    ops = make()
    refs = reference_answers[name]
    assert len(refs) == (2 if jax_fused else 1)
    for method in ("fused", "sorted"):
        got = _port(ops, k, method, algorithm)
        for ref in refs:
            try:
                _agree(got, ref, ops, algorithm, exact=exact)
            except AssertionError as e:
                # name the side whose answer depends on this process
                where = _which_side_moved(name, method, got, refs, ops,
                                          mesh1, tmp_path)
                raise AssertionError(f"{e}\n{where}") from None


def _adversarial(weights):
    """12 nearest rows at stride L = 128: more than the Pallas kernel's
    R=4 registers of one bin (tests/test_pallas_topk.py:68-106)."""
    nt = 4096
    F = len(weights)
    rng = np.random.default_rng(11)
    tn = (np.ones((nt, F), np.float32) if F == 2 and weights[0] == 1.0
          else rng.uniform(5, 6, (nt, F)).astype(np.float32))
    tn[np.arange(0, nt, L)[:12]] = 0.0 if F == 2 else 0.25
    qn = np.zeros((16, F), np.float32)
    return (qn, np.zeros((16, 0), np.int32), tn, np.zeros((nt, 0), np.int32),
            np.asarray(weights), np.zeros(0))


@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.3, 1.7, 2.4)],
                         ids=["unit", "non-unit"])
def test_adversarial_layout(weights, mesh1):
    """The layout that makes every Pallas row suspect: K3 keeps an exact
    list, so it flags nothing and still returns the reference's answer."""
    ops = _adversarial(weights)
    stats = {}
    got = _port(ops, 8, "fused", stats=stats)
    assert stats == {"engine": "fused", "reresolved": 0}
    for ref in _both_jax(ops, 8, mesh1):
        _agree(got, ref, ops, exact=True)
    qf, tf, wsum = distance._fold_weights(ops[0], ops[2], ops[4], ops[5],
                                          "euclidean")
    _, _, suspect = topk.fused_pairwise_topk(
        *[torch.from_numpy(a) for a in (qf, ops[1], tf, ops[3],
                                        ops[5].astype(np.float32))],
        wsum, 1000, 8)
    assert not suspect.any()
    _, _, jsus = jpt.fused_pairwise_topk(qf, ops[1], tf, ops[3], ops[5],
                                         wsum, 1000, 8, mesh=mesh1)
    assert jsus.all()


# K3's split candidate axis: name -> (operands, k, algorithm, exact,
# segment bounds [lo, hi) over the candidate rows)
SPLIT_CASES = {
    "S=1": (lambda: _rand(40, 700, 5, 2, seed=40), 8, "euclidean", False,
            [(0, 700)]),
    "S=2 manhattan": (lambda: _rand(40, 1100, 6, 2, seed=41), 9, "manhattan",
                      False, [(0, 600), (600, 1100)]),
    "S=7 short and empty segments": (
        lambda: _rand(33, 900, 4, 1, seed=42), 16, "euclidean", False,
        [(0, 0), (0, 5), (5, 300), (300, 300), (300, 310), (310, 800),
         (800, 900)]),
    "S=7 manhattan, short and empty segments": (
        lambda: _rand(33, 900, 4, 1, seed=45), 16, "manhattan", False,
        [(0, 5), (5, 5), (5, 128), (128, 256), (256, 260), (260, 900),
         (900, 900)]),
    "nt below k": (lambda: _rand(20, 12, 3, 1, seed=43), 20, "euclidean",
                   False, [(0, 5), (5, 5), (5, 12)]),
    "ties across segment borders": (
        lambda: _repeat_candidates(_rand(30, 100, 4, 2, seed=44), 6), 8,
        "euclidean", False, [(0, 3), (3, 303), (303, 600)]),
    "integer-valued ties, manhattan": (
        lambda: _repeat_candidates(_integer_valued(_rand(30, 90, 5, 2,
                                                         seed=46)), 4),
        12, "manhattan", True, [(0, 2), (2, 181), (181, 183), (183, 360)]),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_path_matches_unsplit_and_reference(name, mesh1):
    """The plain version of K3's split path (``plain_pairwise_topk`` per
    segment, then the merge kernel's plain version) equals the unsplit
    plain version exactly, and the JAX package's fused engine (Pallas in
    interpret mode) under the one-unit contract."""
    make, k, algorithm, exact, bounds = SPLIT_CASES[name]
    ops = make()
    qf, tf, wsum = distance._fold_weights(ops[0], ops[2], ops[4], ops[5],
                                          algorithm)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (qf, ops[1], tf, ops[3], ops[5].astype(np.float32))]
    sv, si = topk.plain_split_pairwise_topk(*args, wsum, 1000, k, bounds,
                                            algorithm)
    pv, pi, _ = topk.plain_pairwise_topk(*args, wsum, 1000, k, algorithm)
    assert torch.equal(sv, pv) and torch.equal(si, pi)
    kk = min(k, len(tf))
    ref = jax_pairwise(*ops, top_k=kk, mesh=mesh1, topk_method="fused",
                       algorithm=algorithm)
    _agree((sv[:, :kk].numpy(), si[:, :kk].numpy()), ref, ops, algorithm,
           exact=exact)
    assert (sv[:, kk:] == 2 ** 31 - 1).all() and (si[:, kk:] == -1).all()


def test_merge_of_sorted_key_lists():
    """The merge kernel's plain version, and its wrapper on CPU tensors:
    the k smallest unique keys of S sorted lists, empty slots last."""
    rng = np.random.default_rng(9)
    S, nq, k = 5, 7, 6
    sent = np.iinfo(np.int64).max
    keys = np.full((S, nq, k), sent, np.int64)
    for s in range(S):
        for r in range(nq):
            n = rng.integers(0, k + 1)                 # short and empty lists
            idx = rng.choice(1000, n, replace=False) + 1000 * s
            v = rng.integers(0, 5, n)                  # ties across lists
            keys[s, r, :n] = np.sort((v << 32) | idx)
    v, i = topk.plain_merge_topk(torch.from_numpy(keys))
    flat = np.sort(keys.transpose(1, 0, 2).reshape(nq, -1), axis=1)[:, :k]
    empty = flat == sent
    np.testing.assert_array_equal(v.numpy(),
                                  np.where(empty, 2 ** 31 - 1, flat >> 32))
    np.testing.assert_array_equal(i.numpy(),
                                  np.where(empty, -1, flat & 0xFFFFFFFF))
    for got, want in zip(topk.merge_topk_lists(torch.from_numpy(keys)),
                         (v, i)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        topk.merge_topk_lists(torch.from_numpy(keys).int())


@pytest.mark.parametrize("nq,nt,split,want", [
    (16384, 16384, None, (128, 3, 43)),     # the kNN job: 128 query tiles
    (64, 65536, None, (64, 256, 2)),        # one query tile: a split axis
    (2048, 1_050_000, None, (128, 33, 249)),  # 528 blocks: 4 whole waves
    (4096, 16384, None, (128, 12, 11)),
    (64, 65536, 1, (64, 1, 512)),           # forced unsplit
    (64, 1000, None, (64, 8, 1)),           # no more segments than tiles
    (40000, 2048, None, (128, 1, 16)),      # enough query tiles alone
    (10, 0, None, (64, 1, 0)),
])
def test_k3_plan(nq, nt, split, want):
    bm, splits, per = topk.k3_plan(nq, nt, 132, split)
    assert (bm, splits, per) == want
    bounds = topk.segment_bounds(nt, splits, per)
    assert bounds[0][0] == 0 and bounds[-1][1] == nt
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi > lo for lo, hi in bounds) or nt == 0


def test_suspect_rows_reresolve_with_unfolded_operands(monkeypatch):
    """Rows the fused engine flags go through the sorted engine with the
    unfolded operands (a folded tnum would apply the weights twice), and
    their count comes back in ``stats``."""
    ops = _rand(40, 900, 3, 1, seed=5)
    want = _port(ops, 6, "sorted")
    real = topk.fused_pairwise_topk

    def flagging(*args, **kw):
        v, i, s = real(*args, **kw)
        s[::3] = True
        v[::3], i[::3] = 0, 0               # wrong on purpose
        return v, i, s

    monkeypatch.setattr(topk, "fused_pairwise_topk", flagging)
    stats = {}
    got = _port(ops, 6, "fused", stats=stats)
    assert stats == {"engine": "fused", "reresolved": 14}
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_dense_and_top_k_match_oracle(mesh1):
    """tests/test_knn.py::test_pairwise_distances_oracle: the dense block
    and its top-k against the float64 oracle and the JAX engine."""
    rng = np.random.default_rng(1)
    qnum, tnum = rng.uniform(0, 1, (13, 3)), rng.uniform(0, 1, (9, 3))
    qcat = rng.integers(0, 3, (13, 2)).astype(np.int32)
    tcat = rng.integers(0, 3, (9, 2)).astype(np.int32)
    nw, cw = np.asarray([1.0, 2.0, 1.0]), np.asarray([1.0, 3.0])
    ops = (qnum, qcat, tnum, tcat, nw, cw)
    for alg in ("euclidean", "manhattan"):
        stats = {}
        dist, idx = pairwise_distances(*ops, algorithm=alg, device="cpu",
                                       stats=stats)
        assert idx is None and stats["engine"] == "dense"
        want, _ = jax_pairwise(*ops, algorithm=alg, mesh=mesh1)
        assert np.abs(dist.astype(np.int64) - want).max() <= 1
        oracle = _oracle(qnum.astype(np.float32), qcat,
                         tnum.astype(np.float32), tcat, nw, cw, alg)
        assert np.abs(dist - oracle).max() <= 1
    dk, ik = pairwise_distances(*ops, top_k=3, device="cpu")
    _agree((dk, ik), jax_pairwise(*ops, top_k=3, mesh=mesh1), ops)


def test_self_join_shape_and_empty_inputs():
    ops = _rand(12, 12, 2, 1, seed=11)
    v, i = _port((ops[0], ops[1], ops[0], ops[1], ops[4], ops[5]), 5,
                 "exact")
    assert (i[:, 0] == np.arange(12)).all() and (v[:, 0] == 0).all()
    v, i = _port((ops[0][:0], ops[1][:0]) + ops[2:], 4, "exact")
    assert v.shape == (0, 4) and i.shape == (0, 4)
    d, _ = pairwise_distances(*ops[:2], ops[2][:0], ops[3][:0], *ops[4:],
                              device="cpu")
    assert d.shape == (12, 0)


@pytest.mark.parametrize("nt,k", [(1500, 16), (4096, 1), (1030, 64)])
def test_topk_smallest_matches_lax_top_k(nt, k):
    """Heavy ties: lowest index first, as ``lax.top_k``."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    d = rng.integers(0, 7, (37, nt)).astype(np.int32)
    wv, wi = jax_topk_smallest(jnp.asarray(d), k)
    gv, gi = distance.topk_smallest(torch.from_numpy(d), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    fv, fi = distance.topk_smallest(torch.from_numpy(d.astype(np.float32)), k)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(wi))


def test_topk_smallest_approx_is_exact():
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.integers(0, 1000, (8, 2048)).astype(np.int32))
    for got, want in zip(distance.topk_smallest(d, 8, method="approx"),
                         distance.topk_smallest(d, 8)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        distance.topk_smallest(d, 8, method="fast")


def test_gates_match_reference():
    algs = ("euclidean", "manhattan", "cosine")
    for alg in algs:
        for k in (0, 1, 16, 64, 65):
            for nt in (1, 700, 2047, 2048, 16384, 1 << 18, 1 << 20):
                for n_num, n_cat in ((0, 0), (8, 2), (64, 0), (65, 2),
                                     (1024, 16), (1025, 0), (0, 17)):
                    for scale in (1000, 10_000, 1 << 20):
                        args = (alg, k, nt, n_num, n_cat, scale)
                        assert (topk.fused_topk_supported(*args)
                                == jpt.fused_topk_supported(*args)), args
                        assert (topk.fused_topk_applicable(*args,
                                                           device="cuda")
                                == jpt.fused_topk_applicable(
                                    *args, backend="tpu")), args
                        assert not topk.fused_topk_applicable(*args,
                                                              device="cpu")


@pytest.mark.parametrize("args,want", [
    # shapes the reference's gate refuses for its packing budget, its
    # 2,048-row threshold or its manhattan feature cap: K3 takes them
    (("euclidean", 16, 1 << 20, 64, 0, 1 << 20), True),
    (("euclidean", 16, 1 << 18, 8, 2, 10_000), True),
    (("manhattan", 16, 16384, 80, 0, 1000), True),
    (("euclidean", 16, 16384, 2048, 0, 1000), True),
    # K3's own limits
    (("euclidean", 65, 16384, 8, 0, 1000), False),
    (("euclidean", 0, 16384, 8, 0, 1000), False),
    (("euclidean", 16, 16384, 8, 17, 1000), False),
    (("euclidean", 16, 16384, 0, 0, 1000), False),
    (("cosine", 16, 16384, 8, 0, 1000), False),
])
def test_k3_gate_uses_the_kernels_own_limits(args, want):
    alg, k, _, n_num, n_cat, _ = args
    assert topk.k3_supported(alg, k, n_num, n_cat) == want
    assert topk.k3_applicable(alg, k, n_num, n_cat, "cuda") == want
    assert not topk.k3_applicable(alg, k, n_num, n_cat, "cpu")


# (nq, nt, F, k, K3 measured faster): chip_smoke.py's crossover grid and
# kernel shapes on an H100 (PERF.md, the K3 engine crossover): K3 is the
# faster engine at every point, so the gate takes it wherever it fits
@pytest.mark.parametrize("nq,nt,F,k,faster", [
    (64, 256, 256, 16, True), (64, 2048, 256, 16, True),
    (64, 16384, 256, 16, True), (64, 65536, 256, 16, True),
    (1024, 256, 256, 16, True), (1024, 2048, 256, 16, True),
    (1024, 65536, 256, 16, True), (4096, 256, 256, 16, True),
    (4096, 2048, 256, 16, True), (4096, 65536, 256, 16, True),
    (16384, 2048, 256, 16, True), (16384, 65536, 256, 16, True),
    (2048, 16384, 256, 64, True), (2048, 1_050_000, 64, 16, True),
    (1024, 65536, 2, 8, True), (4096, 16384, 64, 16, True),
    (4096, 65536, 0, 5, True),
])
def test_k3_gate_follows_the_measured_crossover(nq, nt, F, k, faster):
    n_cat = 0 if F else 8
    assert topk.k3_applicable("euclidean", k, F, n_cat, "cuda") == faster
    # the plan K3 runs such a shape with: whole segments, none empty
    bm, splits, per = topk.k3_plan(nq, nt, 132)
    assert splits * per * 128 >= nt > (splits - 1) * per * 128


def test_forced_fused_errors_match_reference(mesh1):
    ops = _rand(16, 128, 80, 0, seed=5)
    with pytest.raises(ValueError):
        _port(ops, 4, "fused", algorithm="manhattan")
    with pytest.raises(ValueError):
        jax_pairwise(*ops, top_k=4, mesh=mesh1, algorithm="manhattan",
                     topk_method="fused")
    with pytest.raises(ValueError, match="requires top_k"):
        pairwise_distances(*ops, device="cpu", topk_method="fused")


def test_wrapper_checks():
    q = torch.zeros((4, 2))
    e = torch.zeros((4, 0), dtype=torch.int32)
    w = torch.zeros(0)
    with pytest.raises(ValueError, match="k must be"):
        topk.fused_pairwise_topk(q, e, q, e, w, 2.0, 1000, 65)
    with pytest.raises(TypeError):
        topk.fused_pairwise_topk(q.double(), e, q, e, w, 2.0, 1000, 2)
    with pytest.raises(ValueError, match="shapes"):
        topk.fused_pairwise_topk(q, e, torch.zeros((4, 1)), e, w, 2.0, 1000,
                                 2)
    with pytest.raises(ValueError, match="algorithm"):
        topk.fused_pairwise_topk(q, e, q, e, w, 2.0, 1000, 2, "cosine")
    # empty slots when k exceeds the candidates
    v, i, s = topk.fused_pairwise_topk(q, e, q[:2], e[:2], w, 2.0, 1000, 3)
    assert (v[:, 2] == 2 ** 31 - 1).all() and (i[:, 2] == -1).all()
    assert v.dtype == i.dtype == torch.int32 and not s.any()


def test_tf32_is_refused_on_cuda():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            distance._assert_no_tf32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    distance._assert_no_tf32(torch.device("cuda"))


def test_fold_weights_matches_reference():
    from avenir_tpu.ops.distance import _fold_weights
    ops = _rand(5, 7, 3, 2, seed=4)
    for alg in ("euclidean", "manhattan"):
        for a, b in zip(distance._fold_weights(ops[0], ops[2], ops[4], ops[5],
                                               alg),
                        _fold_weights(ops[0], ops[2], ops[4], ops[5], alg)):
            np.testing.assert_array_equal(a, b)
    assert math.isclose(distance._fold_weights(
        ops[0], ops[2], np.zeros(3), np.zeros(2), "euclidean")[2], 1.0)
