"""The port's parse-once ingest cache and warm Naive Bayes training, held
against the JAX package on the CPU.

Cold (cache-writing) and warm (cache-replaying) runs of the port must give
the JAX package's model bytes; the warm run must fold through
``feature_class_counts_rawbin`` (kernel K2 on the card); both packages
must write the same artifact bytes and read each other's artifact; every
fingerprint axis must invalidate.
"""

import json
import os

import numpy as np
import pytest

from avenir_tpu.core import ingestcache as jic
from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import bayesian as jb

from avenir_tpu_torch.core import ingestcache, io, pipeline
from avenir_tpu_torch.core.binning import DatasetEncoder
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models import bayesian as tb

NB_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["red", "green"]},
    {"name": "amount", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "bucketWidth": 7},
    {"name": "score", "ordinal": 3, "dataType": "double", "feature": True},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}
PARTS = ("x.bin", "xraw.bin", "values.bin", "y.bin")


def _rows(n=313, seed=3):
    rng = np.random.default_rng(seed)
    colors = ["blue", "red", "grey", "green", "teal"]
    return [[f"id{i:04d}", colors[rng.integers(len(colors))],
             str(int(rng.integers(0, 100))), f"{rng.uniform(-5, 5):.4f}",
             "NYYN"[int(rng.integers(4))]] for i in range(n)]


@pytest.fixture
def data(tmp_path):
    sp = tmp_path / "schema.json"
    sp.write_text(json.dumps(NB_SCHEMA))
    ip = tmp_path / "in"
    ip.mkdir()
    (ip / "part-00000").write_text(
        "\n".join(",".join(r) for r in _rows()) + "\n")
    return str(sp), str(ip)


def _props(sp, cache_dir, **extra):
    return dict({"feature.schema.file.path": sp,
                 "pipeline.chunk.rows": "101",
                 "ingest.cache.enable": "true",
                 "ingest.cache.dir": str(cache_dir)}, **extra)


def _port(props, ip):
    return tb.BayesianDistribution(JobConfig(dict(props)),
                                   device="cpu")._train_streamed(
        ip, ",", ",", Counters())


def _jax(props, ip):
    return jb.BayesianDistribution(JaxConfig(dict(props)))._train_streamed(
        ip, ",", ",", JaxCounters())


def _artifact(cache_dir):
    (d,) = [d for d in os.listdir(cache_dir)
            if os.path.isfile(os.path.join(cache_dir, d, io.SUCCESS_NAME))]
    return os.path.join(cache_dir, d)


@pytest.fixture
def rawbin_calls(monkeypatch):
    """Counts the warm fold's calls of ``feature_class_counts_rawbin``."""
    calls = []
    real = tb.feature_class_counts_rawbin

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tb, "feature_class_counts_rawbin", spy)
    return calls


def test_cold_warm_byte_parity_with_reference(data, tmp_path, rawbin_calls):
    sp, ip = data
    want = _jax({"feature.schema.file.path": sp,
                 "pipeline.chunk.rows": "101"}, ip)
    cache = tmp_path / "cache"
    assert _port(_props(sp, cache), ip) == want          # cold: writes
    assert rawbin_calls == []
    assert _port(_props(sp, cache), ip) == want          # warm, fused
    assert rawbin_calls == [(101, 3), (101, 3), (101, 3), (10, 3)]
    del rawbin_calls[:]
    assert _port(_props(sp, cache, **{"ingest.cache.fused": "false"}),
                 ip) == want
    assert rawbin_calls == []


def test_warm_run_reads_the_artifact_not_the_input(data, tmp_path):
    """Flip every label in place, keeping the input's size and mtime: the
    stat fingerprint still matches, so the warm model is the old one."""
    sp, ip = data
    cache = tmp_path / "cache"
    want = _port(_props(sp, cache), ip)
    part = os.path.join(ip, "part-00000")
    st = os.stat(part)
    rows = [r[:4] + [{"N": "Y", "Y": "N"}[r[4]]] for r in _rows()]
    with open(part, "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")
    os.utime(part, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert _port(_props(sp, cache), ip) == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifact_bytes_equal_reference(data, tmp_path, writer):
    """Both packages write the same artifact for the same input, and
    each package's warm run replays the other's artifact."""
    sp, ip = data
    jdir, pdir = tmp_path / "jcache", tmp_path / "pcache"
    _jax(_props(sp, jdir), ip)
    _port(_props(sp, pdir), ip)
    ja, pa = _artifact(jdir), _artifact(pdir)
    assert os.path.basename(ja) == os.path.basename(pa)
    for name in PARTS + (ingestcache.META_NAME,):
        with open(os.path.join(ja, name), "rb") as a, \
                open(os.path.join(pa, name), "rb") as b:
            assert a.read() == b.read(), name
    want = _jax({"feature.schema.file.path": sp,
                 "pipeline.chunk.rows": "101"}, ip)
    src = jdir if writer == "jax" else pdir
    reader = _port if writer == "jax" else _jax
    enc = (DatasetEncoder(FeatureSchema.from_file(sp)) if writer == "jax"
           else JaxEncoder(JaxSchema.from_file(sp)))
    cache = (ingestcache.IngestCache if writer == "jax"
             else jic.IngestCache)(str(src), ip, enc, ",")
    assert cache.load(101) is not None
    assert reader(_props(sp, src), ip) == want


def test_invalidation_on_every_fingerprint_axis(data, tmp_path):
    sp, ip = data
    cache = tmp_path / "cache"
    base = _port(_props(sp, cache), ip)
    adir = _artifact(cache)
    enc = lambda path: DatasetEncoder(FeatureSchema.from_file(path))

    # a changed input (size) misses and rebuilds
    with open(os.path.join(ip, "part-00000"), "a") as fh:
        fh.write("\n".join(",".join(r) for r in _rows(40, seed=99)) + "\n")
    grown = _port(_props(sp, cache), ip)
    assert grown != base
    with open(os.path.join(adir, ingestcache.META_NAME)) as fh:
        assert json.load(fh)["n_rows"] == 313 + 40
    assert grown == _jax({"feature.schema.file.path": sp,
                          "pipeline.chunk.rows": "101"}, ip)

    # another bucket width: another encoder fingerprint, another directory
    schema2 = json.loads(json.dumps(NB_SCHEMA))
    schema2["fields"][2]["bucketWidth"] = 13
    sp2 = tmp_path / "schema13.json"
    sp2.write_text(json.dumps(schema2))
    _port(_props(str(sp2), cache), ip)
    assert len([d for d in os.listdir(cache) if d.startswith("enc-")]) == 2

    # another chunk geometry misses; the run still gives the right model
    c = ingestcache.IngestCache(str(cache), ip, enc(sp), ",")
    assert c.load(101) is not None and c.load(64) is None
    assert _port(_props(sp, cache, **{"pipeline.chunk.rows": "64"}),
                 ip) == grown

    # a torn part fails validation, and the next cold run heals it
    xbin = os.path.join(adir, "x.bin")
    with open(xbin, "rb") as fh:
        blob = fh.read()
    with open(xbin, "wb") as fh:
        fh.write(blob[:len(blob) // 2])
    assert c.load(101) is None
    assert _port(_props(sp, cache), ip) == grown
    assert os.path.getsize(xbin) == len(blob)


def test_manifest_validation_and_writer(tmp_path):
    d = str(tmp_path / "art")
    with io.OutputWriter(d, name="a.bin", binary=True,
                         mark_success=False) as w:
        w.write_bytes(b"\x01\x02\x03")
    with io.OutputWriter(d, name="b.txt") as w:
        w.write("line")
    files = [os.path.join(d, n) for n in ("a.bin", "b.txt")]
    io.validate_artifact_dir(d, files)
    assert os.path.isfile(os.path.join(d, io.SUCCESS_NAME))
    with open(files[0], "wb") as fh:
        fh.write(b"\x01\x02\x04")
    with pytest.raises(io.TornArtifactError, match="checksum"):
        io.validate_artifact_dir(d, files)
    with pytest.raises(io.TornArtifactError, match="no longer exist"):
        io.validate_artifact_dir(d, files[1:])
    # an exception inside the writer discards the stage
    with pytest.raises(RuntimeError):
        with io.OutputWriter(d, name="c.bin", binary=True) as w:
            w.write_bytes(b"x")
            raise RuntimeError("boom")
    assert not os.path.exists(os.path.join(d, "c.bin"))
    assert not [f for f in os.listdir(d) if f.startswith(".c.bin")]


def test_builder_abort_leaves_no_artifact(data, tmp_path):
    sp, ip = data
    c = ingestcache.IngestCache(str(tmp_path / "cache"), ip,
                                DatasetEncoder(FeatureSchema.from_file(sp)),
                                ",")
    b = c.builder(50)
    rng = np.random.default_rng(0)
    b.add(rng.integers(0, 5, (50, 3)).astype(np.int32), rng.random((50, 3)),
          rng.integers(0, 2, 50).astype(np.int32), 50)
    b.abort()
    assert b.finish() is False
    assert c.load(50) is None
    assert os.listdir(tmp_path / "cache") == []        # the stage is gone


def test_chunk_transfer_takes_read_only_chunks(tmp_path):
    """The warm path hands mmapped (read-only) chunks to the transfer."""
    a = np.memmap(tmp_path / "m.bin", dtype=np.int32, mode="w+", shape=(4, 3))
    a[:] = np.arange(12).reshape(4, 3)
    a.flush()
    ro = np.memmap(tmp_path / "m.bin", dtype=np.int32, mode="r", shape=(4, 3))
    t, mask = pipeline.ChunkTransfer(tb.resolve_device("cpu"))((ro[1:3],))
    assert mask is None and t.tolist() == [[3, 4, 5], [6, 7, 8]]
