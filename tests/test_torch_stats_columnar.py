"""``NumericalAttrStats``' columnar condition column
(``avenir_tpu_torch/models/discriminant.py``) held against the JAX
package's job, which groups the rows by one Python string a row, on the
CPU.

The port's standalone job and its shared-scan fold (the native column
parser's fixed-width bytes, grouped with array operations) must write
the reference's bytes with and without ``cond.attr.ord``, on condition
values whose sorted text order differs from their first-seen order (one
and two bytes, which take a ``bincount``, and wider ones, which take
``np.unique``), on chunks the native parser refuses, and over empty
chunks; ``FisherDiscriminant``, which reads the same groups, too.
"""

import numpy as np
import pytest
import torch

from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.models import discriminant as jd

from avenir_tpu_torch.cli import job_resolver
from avenir_tpu_torch.core import multiscan
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import discriminant as td
from avenir_tpu_torch.parallel.mesh import make_mesh

#: condition values in first-seen order, none of them first in sorted order
CONDS = {"short": ["b", "Y", "é", "a", "", "ab", "B"],
         "wide": ["zeta", "Alpha", "é-x", "alpha", "b", "ab", "beta"]}


def _rows(conds, n=97, seed=5):
    """``id,int,float,cond`` rows: each condition value first seen in
    ``conds``' order, then drawn at random."""
    rng = np.random.default_rng(seed)
    pick = list(conds) + [conds[int(k)] for k in
                          rng.integers(len(conds), size=n - len(conds))]
    return [f"r{i},{int(rng.integers(-50, 3000))},{rng.random() * 90:.5f},"
            f"{c}" for i, c in enumerate(pick)]


def _write(tmp_path, rows):
    d = tmp_path / "in"
    d.mkdir()
    (d / "part-00000").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return str(d)


def _cfg(cond):
    cfg = {"attr.list": "1,2"}
    if cond is not None:
        cfg["cond.attr.ord"] = cond
    return cfg


def _read(path) -> bytes:
    return (path / "part-r-00000").read_bytes()


def _reference(cfg, in_dir, out):
    jd.NumericalAttrStats(JaxConfig(cfg)).run(in_dir, str(out))
    return _read(out)


def _fused(cfg, in_dir, base, chunk_rows=13):
    props = {"multi.jobs": "stats",
             "multi.job.stats.class": "NumericalAttrStats",
             "pipeline.chunk.rows": str(chunk_rows),
             "pipeline.prefetch.depth": "2"}
    props.update({f"multi.job.stats.{k}": v for k, v in cfg.items()})
    msgs = []
    before = multiscan.STANDALONE_RERUNS
    multiscan.run_multi(JobConfig(props), in_dir, str(base),
                        job_resolver("cpu"),
                        mesh=make_mesh([torch.device("cpu")]),
                        log=msgs.append)
    assert not msgs and multiscan.STANDALONE_RERUNS == before, msgs
    return _read(base / "stats")


@pytest.mark.parametrize("path", ["standalone", "fused"])
@pytest.mark.parametrize("cond", ["3", None])
@pytest.mark.parametrize("values", sorted(CONDS))
def test_stats_bytes_match_reference(tmp_path, values, cond, path):
    in_dir = _write(tmp_path, _rows(CONDS[values]))
    want = _reference(_cfg(cond), in_dir, tmp_path / "ref")
    if path == "standalone":
        td.NumericalAttrStats(JobConfig(_cfg(cond)), device="cpu").run(
            in_dir, str(tmp_path / "port"))
        got = _read(tmp_path / "port")
    else:
        got = _fused(_cfg(cond), in_dir, tmp_path / "fused")
    assert got == want
    if cond is not None:
        labels = [l.split(",")[1] for l in want.decode().splitlines()]
        assert labels[1:len(CONDS[values]) + 1] == sorted(CONDS[values])


def test_fisher_bytes_match_reference(tmp_path):
    """Two classes whose sorted order ("B" < "b") is not their first-seen
    order: the class-conditional rows, and so the sign of the log-odds
    prior, follow the sorted values."""
    in_dir = _write(tmp_path, _rows(["b", "B"], n=80))
    cfg = {"attr.list": "1,2", "cond.attr.ord": "3"}
    td.FisherDiscriminant(JobConfig(cfg), device="cpu").run(
        in_dir, str(tmp_path / "port"))
    jd.FisherDiscriminant(JaxConfig(cfg)).run(in_dir, str(tmp_path / "ref"))
    assert _read(tmp_path / "port") == _read(tmp_path / "ref")


def test_fused_fold_keeps_arrays_not_strings(tmp_path):
    """The fold keeps each chunk's condition column as the parser's
    fixed-width bytes: no Python object a row."""
    in_dir = _write(tmp_path, _rows(CONDS["wide"], n=40))
    spec = td.NumericalAttrStats(JobConfig(_cfg("3")),
                                 device="cpu").fold_spec(
        str(tmp_path / "out"))
    raw = open(f"{in_dir}/part-00000", "rb").read()
    assert spec.encode(multiscan.ChunkContext(raw, ",")) == ()
    assert len(spec._conds) == 1
    conds = spec._conds[0]
    assert isinstance(conds, np.ndarray) and conds.dtype.kind == "S"
    assert conds.dtype.itemsize == max(len(c.encode()) for c in
                                       CONDS["wide"])
    for vals in spec._vals.values():
        assert vals[0].dtype == np.float64


@pytest.mark.parametrize("refused", ["field matrix", "ragged lines"])
@pytest.mark.parametrize("cond", ["3", None])
def test_refused_chunks_take_the_fallback(tmp_path, monkeypatch, refused,
                                          cond):
    """Chunks the native column parser does not take (here: it returns
    None, or a chunk has a line with an extra field) go through the
    chunk's fields and still write the reference's bytes."""
    rows = _rows(CONDS["short"])
    if refused == "field matrix":
        monkeypatch.setattr(multiscan.ChunkContext, "columns",
                            lambda self, ordinals, kinds=None: None)
    else:
        rows[20] += ",extra"
    in_dir = _write(tmp_path, rows)
    want = _reference(_cfg(cond), in_dir, tmp_path / "ref")
    assert _fused(_cfg(cond), in_dir, tmp_path / "fused") == want


@pytest.mark.parametrize("raw", [b"", b"\n\n"])
def test_empty_chunk_is_skipped(tmp_path, raw):
    spec = td.NumericalAttrStats(JobConfig(_cfg("3")),
                                 device="cpu").fold_spec(
        str(tmp_path / "out"))
    assert spec.encode(multiscan.ChunkContext(raw, ",")) is None
    assert spec._conds == [] and all(v == [] for v in spec._vals.values())
