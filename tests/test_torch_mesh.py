"""The port's device mesh (``avenir_tpu_torch/parallel/mesh.py``), its
collectives, the mesh forms of the counting reduce, and the two kernel
forms the multi-device engines use, held against the JAX package on the
CPU.

The reference runs on the eight virtual CPU devices of tests/conftest.py
(``mesh8``); the port on a mesh that names the CPU eight times.  Counts
are integers and must match bit for bit; the collectives move whole
blocks, so their results must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from avenir_tpu.models.bayesian import _nb_local as jax_nb_local
from avenir_tpu.ops import pallas_topk as jpt
from avenir_tpu.ops.counting import sharded_reduce as jax_sharded_reduce
from avenir_tpu.parallel import mesh as jax_mesh

from avenir_tpu_torch.models.bayesian import _nb_local
from avenir_tpu_torch.ops import counting, distance, topk
from avenir_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")


def cpu_mesh(n, data=None, model=1):
    return pmesh.make_mesh([CPU] * n, data=data, model=model)


def test_make_mesh_shapes_repeats_and_errors(monkeypatch):
    m = cpu_mesh(8, data=4, model=2)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.axis_names == ("data", "model")
    assert m.repeated and "repeated" in repr(m) and "4x2" in repr(m)
    assert m.axis_devices("data") == [CPU] * 4
    assert m.axis_devices("model") == [CPU] * 2
    assert len(m.axis_devices(("data", "model"))) == 8
    assert not cpu_mesh(1).repeated and "repeated" not in repr(cpu_mesh(1))
    assert cpu_mesh(8).shape == {"data": 8, "model": 1}
    # the reference's message for a grid that does not fit its devices
    for make in (lambda: cpu_mesh(8, data=3, model=2),
                 lambda: jax_mesh.make_mesh(jax.devices(), data=3, model=2)):
        with pytest.raises(ValueError, match=r"mesh 3x2 != 8 devices"):
            make()
    with pytest.raises(ValueError, match="axis"):
        m.axis_devices("rows")
    with pytest.raises(ValueError):
        pmesh.make_mesh(["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="never both"):
        pmesh.make_mesh(["cpu", "cuda:1"])
    cards = pmesh.make_mesh(["cuda"] * 2 + ["cuda:1"] * 2, data=2, model=2)
    assert list(cards.devices.flat) == [torch.device("cuda", 0)] * 2 + \
        [torch.device("cuda", 1)] * 2
    assert pmesh.make_mesh().devices.size == 4          # every card


@pytest.mark.parametrize("spec,shape", [
    (None, (4, 1)), ("4x1", (4, 1)), ("2x2", (2, 2)), ("1X4", (1, 4)),
    ("2by2", None), ("3x2", None), ("x4", None), ("2x2x1", None)])
def test_avenir_mesh_parsing(spec, shape, monkeypatch):
    """``AVENIR_MESH=<data>x<model>`` over the visible cards (unset,
    every card on the data axis), with the reference's error for a spec
    that does not parse or does not fit (here 4 cards; the reference's
    own parser over its 8 CPU devices refuses the same malformed
    specs)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if spec is None:
        monkeypatch.delenv("AVENIR_MESH", raising=False)
    else:
        monkeypatch.setenv("AVENIR_MESH", spec)
    if shape is None:
        with pytest.raises(ValueError, match=r"bad AVENIR_MESH=.*device "
                                             r"count \(4\)"):
            pmesh.get_mesh()
        if spec != "3x2":                  # 3x2 fits neither 4 nor 8
            with pytest.raises(ValueError, match="bad AVENIR_MESH"):
                jax_mesh._mesh_from_env()
        return
    m = pmesh.get_mesh()
    assert (m.shape["data"], m.shape["model"]) == shape
    # unset, every visible card on the data axis, as the reference's
    assert list(m.devices.flat) == [torch.device("cuda", i)
                                    for i in range(4)]


def test_get_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("AVENIR_MESH", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.get_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()


def test_device_module_reexports_pad_rows():
    from avenir_tpu_torch.device import pad_rows
    assert pad_rows is pmesh.pad_rows


@pytest.mark.parametrize("n,axis", [(8, "data"), (13, "data"), (13, "model"),
                                    (0, "data"), (13, ("data", "model"))])
def test_pad_and_shard_rows_round_trip(n, axis, mesh8):
    """``pad_rows`` then ``shard_rows``: each shard holds the rows the
    reference's ``shard_rows`` puts on that device, and the shards laid
    back together give the padded rows."""
    a = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    m = cpu_mesh(8, data=4, model=2)
    shards_n = len(m.axis_devices(axis))
    padded, mask = pmesh.pad_rows(a, shards_n, fill=-1)
    want, wmask = jax_mesh.pad_rows(a, shards_n, fill=-1)
    np.testing.assert_array_equal(padded, want)
    np.testing.assert_array_equal(mask, wmask)
    shards = pmesh.shard_rows(padded, m, axis)
    assert len(shards) == shards_n
    assert all(s.device == CPU and s.is_contiguous() for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), padded)
    jm = jax_mesh.make_mesh(jax.devices(), data=4, model=2)
    ref = jax_mesh.shard_rows(want, jm, axis)
    rows = padded.shape[0] // shards_n
    for s in ref.addressable_shards:
        lo = s.index[0].start or 0
        np.testing.assert_array_equal(shards[lo // rows if rows else 0]
                                      .numpy(), np.asarray(s.data))
    if n % 2:
        with pytest.raises(ValueError, match="pad them first"):
            pmesh.shard_rows(a, m, "model")


def test_split_rows_and_shard_grid():
    a = torch.arange(11 * 2).reshape(11, 2)
    parts = pmesh.split_rows(a, 4)
    assert [p.shape[0] for p in parts] == [3, 3, 3, 2]
    assert [p.shape[0] for p in pmesh.split_rows(a[:2], 4)] == [1, 1, 0, 0]
    m = cpu_mesh(8, data=4, model=2)
    g = pmesh.shard_grid(a, m, "data")
    assert all(g[i][0] is g[i][1] for i in range(4))     # one copy a device
    assert torch.equal(torch.cat([row[0] for row in g]), a)
    g = pmesh.shard_grid(a, m, "model")
    assert torch.equal(torch.cat(g[0]), a) and g[3][1].shape[0] == 5
    g = pmesh.shard_grid(a, m)
    assert all(torch.equal(x, a) for row in g for x in row)
    assert len(pmesh.replicate(a, m)) == 8


def _reference_collectives(mesh8, blocks):
    """The reference's ppermute (the ring's perm), all_gather and psum
    over the data axis of ``mesh8``, on per-device blocks."""
    from avenir_tpu.parallel.mesh import shard_map
    d = len(blocks)
    perm = [((i + 1) % d, i) for i in range(d)]

    def local(x):
        return (jax.lax.ppermute(x, "data", perm),
                jax.lax.all_gather(x, "data", axis=0, tiled=True),
                jax.lax.psum(x, "data"))

    fn = jax.jit(shard_map(local, mesh=mesh8, in_specs=(P("data"),),
                           out_specs=(P("data"), P("data"), P("data"))))
    outs = fn(jnp.asarray(np.concatenate(blocks)))
    return [np.split(np.asarray(a), d) for a in outs]


def test_collectives_match_reference(mesh8):
    """``ppermute_ring``: shard i receives shard i + 1's block, the
    reference's ``perm = [((i + 1) % d, i)]`` (distance.py:250, :369);
    ``all_gather`` and ``psum`` as the reference's over the same shards."""
    rng = np.random.default_rng(3)
    blocks = [rng.integers(-50, 50, (2, 3)).astype(np.int32)
              for _ in range(8)]
    shards = [torch.from_numpy(b) for b in blocks]
    want_perm, want_gather, want_sum = _reference_collectives(mesh8, blocks)
    for got, want in zip(pmesh.ppermute_ring(shards), want_perm):
        np.testing.assert_array_equal(got.numpy(), want)
    assert [int(s[0, 0]) for s in pmesh.ppermute_ring(shards)] == \
        [int(blocks[(i + 1) % 8][0, 0]) for i in range(8)]
    gathered = pmesh.all_gather(shards)
    for got, want in zip(gathered, want_gather):
        np.testing.assert_array_equal(got.numpy(), want)
    assert all(g is gathered[0] for g in gathered)     # one device
    summed = pmesh.psum(shards)
    for got, want in zip(summed, want_sum):
        np.testing.assert_array_equal(got.numpy(), want[:2])
    assert torch.equal(shards[0], torch.from_numpy(blocks[0]))  # untouched


def _churn_codes(n, seed):
    """Codes of the NB main path's table (2 classes, 6 features, 16
    bins), with -1 entries, out-of-range bins and classes."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 18, (n, 6)).astype(np.int8),
            rng.integers(-1, 3, n).astype(np.int8))


@pytest.mark.parametrize("n", [10_001, 5, 8])
def test_sharded_reduce_on_a_mesh_matches_reference(n, mesh8):
    """The churn count table on a CPU mesh of 8 (as 8x1 and 4x2), on one
    shard, on one device and through the reference's ``sharded_reduce``
    on ``mesh8``: int32 and bit for bit."""
    x, y = _churn_codes(n, seed=n)
    want = np.asarray(jax_sharded_reduce(jax_nb_local, x, y, mesh=mesh8,
                                         static_args=(2, 16)))
    one = counting.sharded_reduce(_nb_local, x, y, device=CPU,
                                  static_args=(2, 16))
    assert one.dtype == torch.int32
    np.testing.assert_array_equal(one.numpy(), want)
    for m in (cpu_mesh(8), cpu_mesh(8, data=4, model=2), cpu_mesh(1)):
        got = counting.sharded_reduce(_nb_local, x, y, mesh=m,
                                      static_args=(2, 16))
        assert got.dtype == torch.int32 and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_reduce_resident_and_pytrees():
    """Rows placed once with ``shard_rows`` (padded to the position
    count, with the mask), and a ``local_fn`` that returns a tuple and a
    dict of tables: each summed over the shards."""
    x, y = _churn_codes(1001, seed=4)
    m = cpu_mesh(8, data=2, model=4)
    xs, mask = pmesh.pad_rows(x, 8)
    ys, _ = pmesh.pad_rows(y, 8)
    placed = [pmesh.shard_rows(a, m, ("data", "model")) for a in (xs, ys)]
    masks = pmesh.shard_rows(mask, m, ("data", "model"))
    want = counting.sharded_reduce(_nb_local, x, y, device=CPU,
                                   static_args=(2, 16))

    def both(xc, yc, mc, n_class, max_bins):
        c = _nb_local(xc, yc, mc, n_class, max_bins)
        return c, c.sum(dim=0)

    c, s = counting.sharded_reduce_resident(both, *placed, mask=masks,
                                            mesh=m, static_args=(2, 16))
    assert torch.equal(c, want) and torch.equal(s, want.sum(dim=0))
    d = counting.sharded_reduce_resident(
        lambda xc, yc, mc: {"rows": mc.sum()}, *placed, mask=masks, mesh=m)
    assert int(d["rows"]) == 1001
    with pytest.raises(ValueError, match="exactly one"):
        counting.sharded_reduce(_nb_local, x, y, static_args=(2, 16))
    with pytest.raises(ValueError, match="exactly one"):
        counting.sharded_reduce(_nb_local, x, y, device=CPU, mesh=m,
                                static_args=(2, 16))


@pytest.mark.parametrize("m_ax", [1, 2, 4, 8])
def test_gates_with_the_model_axis_match_reference(m_ax):
    """``fused_topk_supported`` / ``fused_topk_applicable`` with ``m_ax``
    (pallas_topk.py:119-156): the packing budget over one model shard's
    segment."""
    for alg in ("euclidean", "manhattan"):
        for k in (1, 16, 65):
            for nt in (1, 700, 2048, 16384, (1 << 18) + 1, 1 << 21):
                for n_num, n_cat in ((8, 2), (64, 0), (0, 17)):
                    for scale in (1000, 1 << 13, 1 << 20):
                        args = (alg, k, nt, n_num, n_cat, scale)
                        assert (topk.fused_topk_supported(*args, m_ax=m_ax)
                                == jpt.fused_topk_supported(*args,
                                                            m_ax=m_ax)), args
                        assert (topk.fused_topk_applicable(
                                    *args, device="cuda", m_ax=m_ax)
                                == jpt.fused_topk_applicable(
                                    *args, backend="tpu", m_ax=m_ax)), args


def _operands(nq, nt, F, C, seed):
    rng = np.random.default_rng(seed)
    qn = rng.uniform(0, 1, (nq, F)).astype(np.float32)
    tn = rng.uniform(0, 1, (nt, F)).astype(np.float32)
    qc = rng.integers(0, 4, (nq, C)).astype(np.int32)
    tc = rng.integers(0, 4, (nt, C)).astype(np.int32)
    nw, cw = rng.uniform(0.5, 2, F), rng.uniform(0.5, 2, C)
    qf, tf, wsum = distance._fold_weights(qn, tn, nw, cw, "euclidean")
    return [torch.from_numpy(a) for a in
            (qf, qc, tf, tc, cw.astype(np.float32))], wsum


@pytest.mark.parametrize("nq,nt,k,base", [
    (40, 700, 8, 0), (33, 2900, 16, 5_000), (7, 3, 5, 2 ** 31 - 4),
    (0, 50, 4, 9)])
def test_segment_keys_and_keys_out_merge(nq, nt, k, base):
    """K3's keys-out form with an index base (the plain version on the
    CPU, one segment) and the merge's keys-out form, in place into list 0
    as a ring hop runs it, over a carry and the lists of three segments:
    the merged keys are the one-device answer with its indices shifted by
    ``base``, and the k-th values are the answer's k-th column."""
    ops, wsum = _operands(nq, nt, 6, 2, seed=nt)
    assert topk.device_plan(nq, nt, CPU)[1] == 1
    keys = topk.segment_keys(*ops, wsum, 1000, k, base=base)
    assert keys.shape == (1, nq, k) and keys.dtype == torch.int64
    assert torch.equal(keys, topk.plain_segment_keys(
        *ops, wsum, 1000, k, [(0, nt)], base=base))
    _, splits, per = topk.k3_plan(nq, nt, 1, split=3)
    lists = topk.plain_segment_keys(*ops, wsum, 1000, k,
                                    topk.segment_bounds(nt, splits, per),
                                    base=base)
    v, i, _ = topk.plain_pairwise_topk(*ops, wsum, 1000, k)
    for merged in (keys, lists):
        scratch = torch.cat([torch.full((1, nq, k), topk._SENT64), merged])
        kth = torch.full((nq,), 7, dtype=torch.int32)
        out = topk.merge_topk_keys(scratch, scratch[0], kth)
        assert out.data_ptr() == scratch.data_ptr()
        mv, mi = topk.split_keys(scratch[0])
        assert torch.equal(mv, v)
        assert torch.equal(mi, torch.where(i >= 0, i + base, -1))
        assert torch.equal(kth, v[:, k - 1])
        assert torch.equal(topk.plain_merge_topk_keys(scratch[:1]),
                           scratch[0])
    with pytest.raises(ValueError, match="index base"):
        topk.segment_keys(*ops, wsum, 1000, k, base=2 ** 31 - nt)
    with pytest.raises(ValueError, match="out must be"):
        topk.segment_keys(*ops, wsum, 1000, k,
                          out=torch.empty((2, nq, k), dtype=torch.int64))
    with pytest.raises(ValueError, match="kth must be"):
        topk.merge_topk_keys(scratch, scratch[0], kth.long())
