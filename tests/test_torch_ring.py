"""The port's multi-device kNN engines held against the JAX package on the
CPU: the ring ``pairwise_topk_ring`` (both selections), the sharded
``fused_pairwise_topk`` and ``pairwise_distances(mesh=)``, and the
distance job on a mesh.

Shapes and seeds are those of the reference's own ring and 2-D cases
(tests/test_knn.py:414-660, tests/test_pallas_topk.py:133-170 and :343).
The reference runs on the ``mesh8`` / ``mesh1`` fixtures of
tests/conftest.py (its Pallas kernel in interpret mode, as its own tests
run it); the port on a mesh naming the CPU as many times.  Each
reference answer is computed once, in a module-scope fixture.

Tolerances:

- the port against itself: exact.  The ``bins`` ring and both 2-D
  engines give the port's one-device answer, values and indices.  The
  ``sort`` ring gives its values; among equal distances it keeps ring
  arrival order, as the reference's does, so its indices are held where
  the value is unique in the row, and every index must carry its value
  in the port's dense matrix;
- the port against the reference: the kNN one-unit contract
  (``avenir_tpu/ops/distance.py:454-458``, ``test_torch_distance._agree``):
  values within one unit, rows that differ under 1% of the rows and each
  confirmed by a float64 oracle.  The reference's ``bins`` ring keeps bin
  order among ties (its documented divergence, test_knn.py:440-444), so
  against it only the values are held, and the indices whose value is
  unique in the row.  At ``scale = 2^28`` the port's ring is held to its
  own broadcast engine only, as the reference's case holds the
  reference's (a float32 ulp of a distance spans hundreds of units).
"""

import numpy as np
import pytest
import torch

from avenir_tpu.ops import pallas_topk as jpt
from avenir_tpu.ops.distance import pairwise_distances as jax_pairwise
from avenir_tpu.ops.distance import pairwise_topk_ring as jax_ring

from avenir_tpu_torch.ops.distance import pairwise_distances, \
    pairwise_topk_ring
from avenir_tpu_torch.parallel import make_mesh
from test_torch_distance import _agree, _rand

CPU = torch.device("cpu")


def cpu_mesh(n, data=None, model=1):
    return make_mesh([CPU] * n, data=data, model=model)


def _uniform(nq, nt, F, C, seed, hi=10.0, unit_weights=False):
    rng = np.random.default_rng(seed)
    qn = rng.uniform(0, hi, (nq, F)).astype(np.float32)
    tn = rng.uniform(0, hi, (nt, F)).astype(np.float32)
    qc = rng.integers(0, 4, (nq, C)).astype(np.int32)
    tc = rng.integers(0, 4, (nt, C)).astype(np.int32)
    if unit_weights:
        return qn, qc, tn, tc, np.ones(F), np.ones(C)
    return qn, qc, tn, tc, rng.uniform(0.5, 2.0, F), rng.uniform(0.5, 2.0, C)


def _single_device():
    rng = np.random.default_rng(5)
    return (rng.uniform(0, 1, (9, 3)).astype(np.float32),
            np.zeros((9, 0), np.int32),
            rng.uniform(0, 1, (17, 3)).astype(np.float32),
            np.zeros((17, 0), np.int32), np.ones(3), np.zeros(0))


def _categorical():
    rng = np.random.default_rng(2)
    return (np.zeros((11, 0), np.float32),
            rng.integers(0, 3, (11, 3)).astype(np.int32),
            np.zeros((37, 0), np.float32),
            rng.integers(0, 3, (37, 3)).astype(np.int32), np.zeros(0),
            np.ones(3))


def _numeric(nq, nt, F, seed):
    rng = np.random.default_rng(seed)
    qn = rng.uniform(0, 10, (nq, F)).astype(np.float32)
    tn = rng.uniform(0, 10, (nt, F)).astype(np.float32)
    return (qn, np.zeros((nq, 0), np.int32), tn, np.zeros((nt, 0), np.int32),
            rng.uniform(0.5, 2, F), np.zeros(0))


def _collision():
    """All near neighbours at stride-L global indices: one bin of the
    reference's kernel holds more than its R registers
    (test_knn.py:598-620)."""
    L, nt = jpt._L, 2048
    tn = np.full((nt, 2), 9.0, np.float32)
    tn[np.arange(0, nt, L)[:12]] = 0.0
    return (np.zeros((8, 2), np.float32), np.zeros((8, 0), np.int32), tn,
            np.zeros((nt, 0), np.int32), np.asarray([0.4, 2.2]), np.zeros(0))


def _scale_gate():
    rng = np.random.default_rng(5)
    return (rng.uniform(0, 1, (9, 3)).astype(np.float32),
            np.zeros((9, 0), np.int32),
            rng.uniform(0, 1, (200, 3)).astype(np.float32),
            np.zeros((200, 0), np.int32), np.ones(3), np.zeros(0))


# name: (operands, k, algorithm, scale, mesh size, the reference's ring
# selections, whether the reference ring segments its hops at 512 rows)
RING_CASES = {
    "broadcast parity, nq and nt not dividing the mesh": (
        lambda: _uniform(53, 101, 5, 2, seed=13), 7, "euclidean", 1000, 8,
        ("auto",), False),
    "single device": (_single_device, 4, "euclidean", 1000, 1, ("auto",),
                      False),
    "pure categorical": (_categorical, 5, "euclidean", 1000, 8, ("auto",),
                         False),
    "bins = sort, mesh of 8": (lambda: _numeric(37, 533, 4, seed=21), 6,
                               "euclidean", 1000, 8, ("bins", "sort"),
                               False),
    "bins = sort, mesh of 1": (lambda: _numeric(37, 533, 4, seed=21), 6,
                               "euclidean", 1000, 1, ("bins", "sort"),
                               False),
    "segmented hop at nt = 2,900, mesh of 8": (
        lambda: _numeric(24, 2900, 3, seed=31), 5, "euclidean", 1000, 8,
        ("bins",), True),
    "segmented hop at nt = 2,900, mesh of 1": (
        lambda: _numeric(24, 2900, 3, seed=31), 5, "euclidean", 1000, 1,
        ("bins",), True),
    "stride-L adversarial collision": (_collision, 8, "euclidean", 1000, 8,
                                       ("bins",), False),
    "scale 2^28 auto gate": (_scale_gate, 4, "euclidean", 1 << 28, 8,
                             ("auto",), False),
    "manhattan": (lambda: _numeric(30, 700, 5, seed=23), 6, "manhattan",
                  1000, 8, ("bins",), False),
}


@pytest.fixture(scope="module")
def ring_reference(mesh8, mesh1):
    """``{case: {"broadcast": (v, i), "dense": d, <selection>: (v, i)}}``
    from the JAX package: its sorted broadcast engine, its dense matrix
    and its ring at each selection the case names."""
    from avenir_tpu.ops import distance as jdist
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (make, k, alg, scale, n, sels, seg) in RING_CASES.items():
            ops = make()
            mesh = mesh8 if n == 8 else mesh1
            mp.setattr(jpt, "_SEG", 512 if seg else jpt._SEG)
            jdist._ring_bins_cache.clear()
            kw = dict(algorithm=alg, scale=scale, mesh=mesh)
            ans = {"broadcast": jax_pairwise(*ops, top_k=k,
                                             topk_method="sorted", **kw),
                   "dense": jax_pairwise(*ops, **kw)[0]}
            for sel in sels:
                ans[sel] = jax_ring(*ops, k, selection=sel, **kw)
            out[name] = ans
    jdist._ring_bins_cache.clear()
    return out


def _unique_in_row(dense, vals):
    """Mask of the entries of ``vals`` whose value occurs once in its row
    of ``dense``."""
    out = np.zeros(vals.shape, bool)
    for r in range(len(vals)):
        u, c = np.unique(dense[r], return_counts=True)
        out[r] = np.isin(vals[r], u[c == 1])
    return out


def _hold_values_to_reference(got, want, dense_ref):
    """The reference's ring answers: values within one unit, indices where
    the value is unique in the reference's row."""
    (gv, gi), (wv, wi) = got, want
    assert np.abs(gv.astype(np.int64) - wv).max(initial=0) <= 1
    same = (gv == wv) & _unique_in_row(dense_ref, wv)
    np.testing.assert_array_equal(gi[same], wi[same])


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_matches_broadcast_and_reference(name, ring_reference):
    make, k, alg, scale, n, sels, _ = RING_CASES[name]
    ops = make()
    ref = ring_reference[name]
    mesh = cpu_mesh(n)
    kk = min(k, ops[2].shape[0])
    one = pairwise_distances(*ops, algorithm=alg, scale=scale, top_k=kk,
                             device="cpu")
    dense, _ = pairwise_distances(*ops, algorithm=alg, scale=scale,
                                  device="cpu")
    exact_scale = scale == 1000
    sels_here = ("bins", "sort", "auto") if exact_scale else ("sort", "auto")
    if not exact_scale:
        # past the reference's packing budget: the same refusal of 'bins'
        with pytest.raises(ValueError, match="fused engine's caps"):
            pairwise_topk_ring(*ops, k, algorithm=alg, scale=scale,
                               mesh=mesh, selection="bins")
    for sel in sels_here:
        stats = {}
        v, i = pairwise_topk_ring(*ops, k, algorithm=alg, scale=scale,
                                  mesh=mesh, selection=sel, stats=stats)
        assert stats == {"selection": "sort" if sel == "auto" else sel,
                         "reresolved": 0}
        # the port against its own one-device engine
        np.testing.assert_array_equal(v, one[0])
        np.testing.assert_array_equal(np.take_along_axis(dense, i, 1), v)
        if sel == "bins":
            np.testing.assert_array_equal(i, one[1])
        else:
            uniq = _unique_in_row(dense, v)
            np.testing.assert_array_equal(i[uniq], one[1][uniq])
        # the port against the reference (at scale 2^28 one float32 ulp of
        # a distance spans hundreds of int units, so the one-unit contract
        # has no meaning there: the reference's own case holds its ring to
        # its own broadcast engine only, and so does this one)
        if not exact_scale:
            continue
        if sel == "bins":
            _agree((v, i), ref["broadcast"], ops, alg)
        for rsel in sels:
            if rsel == sel or (rsel == "auto" and sel == "sort"):
                if rsel == "bins":
                    _hold_values_to_reference((v, i), ref[rsel],
                                              ref["dense"])
                else:
                    _agree((v, i), ref[rsel], ops, alg)
    if not exact_scale:
        assert not jpt.fused_topk_supported(alg, kk, ops[2].shape[0],
                                            ops[0].shape[1], 0, scale,
                                            m_ax=n)


def test_ring_errors_match_reference(mesh8):
    ops = _numeric(5, 40, 3, seed=1)
    for ring, mesh in ((pairwise_topk_ring, cpu_mesh(8)), (jax_ring, mesh8)):
        with pytest.raises(ValueError, match="unknown ring selection"):
            ring(*ops, 3, mesh=mesh, selection="heap")
        with pytest.raises(ValueError, match="fused engine's caps"):
            ring(*ops, 3, mesh=mesh, selection="bins", scale=1 << 28)
        with pytest.raises(ValueError, match="fused engine's caps"):
            ring(*ops, 3, mesh=mesh, selection="bins", algorithm="cosine")


# the 2-D engines: name -> (operands, k)
MESH2_CASES = {
    "mixed (test_pallas_topk.py:133)": (lambda: _rand(96, 1111, 5, 2, seed=7),
                                        7),
    "ties (test_pallas_topk.py:147)": (
        lambda: tuple(np.repeat(a, 5, axis=0) if j in (2, 3) else a
                      for j, a in enumerate(_rand(40, 150, 4, 0, seed=8))),
        9),
    "pure categorical (test_pallas_topk.py:158)": (
        lambda: _rand(16, 64, 0, 3, seed=9), 3),
    "2-D mesh (test_knn.py:484)": (
        lambda: _uniform(23, 57, 4, 2, seed=21, unit_weights=True), 6),
}
MESH_SHAPES = [(1, 1), (8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.fixture(scope="module")
def mesh2_reference(mesh8):
    """The reference's fused and sorted engines on ``make_mesh(data=4,
    model=2)`` for every case of MESH2_CASES."""
    from avenir_tpu.parallel import make_mesh as jax_make_mesh
    mesh42 = jax_make_mesh(data=4, model=2)
    return {name: [jax_pairwise(*make(), top_k=k, mesh=mesh42,
                                topk_method=m) for m in ("fused", "sorted")]
            for name, (make, k) in MESH2_CASES.items()}


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", list(MESH2_CASES))
def test_2d_engines_match_one_device_and_reference(name, shape,
                                                   mesh2_reference):
    make, k = MESH2_CASES[name]
    ops = make()
    data, model = shape
    mesh = cpu_mesh(data * model, data=data, model=model)
    one = pairwise_distances(*ops, top_k=k, device="cpu")
    for method in ("fused", "sorted", "exact"):
        stats = {}
        got = pairwise_distances(*ops, top_k=k, mesh=mesh,
                                 topk_method=method, stats=stats)
        assert stats == {"engine": "sorted" if method == "exact" else method,
                         "reresolved": 0}
        np.testing.assert_array_equal(got[0], one[0])
        np.testing.assert_array_equal(got[1], one[1])
        for ref in mesh2_reference[name]:
            _agree(got, ref, ops)
    dense, none = pairwise_distances(*ops, mesh=mesh)
    assert none is None
    np.testing.assert_array_equal(dense, pairwise_distances(
        *ops, device="cpu")[0])


def test_mesh_and_device_together_are_refused():
    ops = _rand(4, 9, 2, 0, seed=1)
    with pytest.raises(ValueError, match="not both"):
        pairwise_distances(*ops, top_k=2, device="cpu", mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="requires top_k"):
        pairwise_distances(*ops, mesh=cpu_mesh(2), topk_method="fused")
    with pytest.raises(ValueError, match="split applies"):
        from avenir_tpu_torch.ops import topk
        t = [torch.zeros((4, 2)), torch.zeros((4, 0), dtype=torch.int32)]
        topk.fused_pairwise_topk(t[0], t[1], t[0], t[1], torch.zeros(0), 2.0,
                                 1000, 2, split=2, mesh=cpu_mesh(2))


def test_distance_job_on_a_mesh_writes_the_same_bytes(tmp_path):
    """``SameTypeSimilarity.run(in, out, mesh=)`` (the reference's job
    signature, avenir_tpu/models/knn.py:111): the same pair file at every
    mesh shape, top-k and all pairs."""
    import json
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.models.knn import SameTypeSimilarity

    rng = np.random.default_rng(17)
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
              {"name": "x", "ordinal": 1, "dataType": "int", "feature": True,
               "min": 0, "max": 100},
              {"name": "y", "ordinal": 2, "dataType": "int", "feature": True,
               "min": 0, "max": 100},
              {"name": "g", "ordinal": 3, "dataType": "categorical",
               "feature": True, "cardinality": ["a", "b", "c"]},
              {"name": "label", "ordinal": 4, "dataType": "categorical",
               "cardinality": ["N", "Y"]}]
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps({"fields": fields}))
    inp = tmp_path / "inp"
    inp.mkdir()
    for prefix, n in (("tr", 61), ("te", 19)):
        rows = [f"{prefix}{r},{rng.integers(0, 100)},{rng.integers(0, 100)},"
                f"{'abc'[rng.integers(0, 3)]},{'NY'[rng.integers(0, 2)]}"
                for r in range(n)]
        (inp / f"{prefix}.txt").write_text("\n".join(rows) + "\n")
    for top in ("5", None):
        conf = {"feature.schema.file.path": str(schema)}
        if top:
            conf["output.top.matches"] = top
        outs = []
        for mesh in (None, cpu_mesh(8), cpu_mesh(8, data=2, model=4)):
            out = tmp_path / f"out_{top}_{len(outs)}"
            SameTypeSimilarity(JobConfig(conf), device="cpu").run(
                str(inp), str(out), mesh=mesh)
            outs.append((out / "part-r-00000").read_bytes())
        assert outs[0] and outs[1] == outs[0] and outs[2] == outs[0]


def test_ring_reresolves_flagged_rows(monkeypatch):
    """The reference's re-resolve path (distance.py:220-229), which an
    exact hop never takes: rows flagged suspect go through the sorted
    engine on the same mesh, and their count comes back in ``stats``."""
    from avenir_tpu_torch.ops import distance
    ops = _numeric(30, 300, 4, seed=3)
    want = pairwise_distances(*ops, top_k=5, device="cpu")
    real = distance._ring_bins

    def flagging(*args):
        vals, idxs, suspect = real(*args)
        for v, i, s in zip(vals, idxs, suspect):
            v[::2], i[::2], s[::2] = 0, 0, True     # wrong on purpose
        return vals, idxs, suspect

    monkeypatch.setattr(distance, "_ring_bins", flagging)
    stats = {}
    got = pairwise_topk_ring(*ops, 5, mesh=cpu_mesh(4), selection="bins",
                             stats=stats)
    assert stats == {"selection": "bins", "reresolved": 4 + 4 + 4 + 3}
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("case", ["scale 2^28", "manhattan past 64 columns",
                                  "euclidean past 1,024 columns",
                                  "inside the caps"])
def test_ring_auto_holds_the_reference_caps_on_the_card_gate(case,
                                                             monkeypatch):
    """Where the card's gate (``k3_applicable``) holds, ``auto`` takes
    ``bins`` only inside the limits that a forced ``bins`` is held to, as
    the reference's gate does (distance.py:207-214): past them it answers
    through ``sort`` and never raises.  The gate is forced true here, so
    that the CPU mesh sees the card's choice."""
    from avenir_tpu_torch.ops import topk
    ops, alg, scale = {
        "scale 2^28": (_scale_gate(), "euclidean", 1 << 28),
        "manhattan past 64 columns": (_numeric(6, 40, 65, seed=3),
                                      "manhattan", 1000),
        "euclidean past 1,024 columns": (_numeric(6, 40, 1025, seed=4),
                                         "euclidean", 1000),
        "inside the caps": (_numeric(6, 40, 5, seed=5), "euclidean", 1000),
    }[case]
    monkeypatch.setattr(topk, "k3_applicable", lambda *a, **kw: True)
    mesh = cpu_mesh(4)
    want = "bins" if case == "inside the caps" else "sort"
    stats = {}
    got = pairwise_topk_ring(*ops, 4, algorithm=alg, scale=scale, mesh=mesh,
                             stats=stats)
    assert stats == {"selection": want, "reresolved": 0}
    ans = pairwise_topk_ring(*ops, 4, algorithm=alg, scale=scale, mesh=mesh,
                             selection=want)
    np.testing.assert_array_equal(got[0], ans[0])
    np.testing.assert_array_equal(got[1], ans[1])
