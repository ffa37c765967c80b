"""The port's native C ingest held against the JAX package's and against
the port's own numpy encoder, on the CPU.

The C source is the reference's, built by each package on its own.  The
chunked and one-shot encodes must give the same ``x``, ``values`` (bit
for bit), ``y``, row counts, chunking and vocabulary order as the
reference's native encode and as the port's numpy encoder, at
``ingest.parse.threads`` 1 and 4 and with the pthread encode forced on;
inputs carry blank lines, a missing final newline and negative bins.
Models trained through the port's CLI are byte-identical to the
reference's.
"""

import json
import os

import numpy as np
import pytest

from avenir_tpu import native as jnative
from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
from avenir_tpu.core.binning import _rows_hint as jax_rows_hint
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import bayesian as jb

from avenir_tpu_torch import native
from avenir_tpu_torch.cli import main as cli_main
from avenir_tpu_torch.core.binning import (ChunkedEncodeUnsupported,
                                           DatasetEncoder, _rows_hint)
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import read_field_matrix
from avenir_tpu_torch.core.parparse import (OrderedParsePool,
                                            parse_threads_from_config)
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models import bayesian as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["red", "green"]},
    {"name": "amount", "ordinal": 2, "dataType": "int", "feature": True,
     "min": -100, "max": 100, "bucketWidth": 7},
    {"name": "score", "ordinal": 3, "dataType": "double", "feature": True},
    {"name": "visits", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 0, "max": 60, "bucketWidth": 5},
    {"name": "label", "ordinal": 5, "dataType": "categorical",
     "cardinality": ["N", "Y"]}]}
# the churn runbook's schema: no negative bins, so the streamed trainer
# keeps its chunked path (a negative bin falls back to the one-shot encode)
CHURN_SCHEMA = os.path.join(REPO, "resource", "churn_nb", "teleComChurn.json")


def _rows(n, seed):
    """Rows whose colours first appear at staggered positions, so the
    vocabulary order depends on the scan order."""
    rng = np.random.default_rng(seed)
    colors = [f"c{i}" for i in range(17)] + ["red", "green"]
    rows = []
    for i in range(n):
        pool = colors[:max(2, min(len(colors), i // 150 + 2))]
        rows.append([f"id{i:05d}", pool[int(rng.integers(len(pool)))],
                     str(int(rng.integers(-100, 100))),
                     f"{rng.uniform(-5, 5):.{int(rng.integers(0, 7))}f}",
                     str(int(rng.integers(0, 60))),
                     "Y" if rng.random() < 0.3 else "N"])
    return rows


def _text(rows, blank_lines=False, final_newline=True):
    lines = [",".join(r) for r in rows]
    if blank_lines:
        for at in (7, 700, 701, len(lines) // 2):
            lines.insert(at, "")
    text = "\n".join(lines)
    return text + "\n" if final_newline else text


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    (d / "schema.json").write_text(json.dumps(SCHEMA))
    rows = _rows(3000, seed=41)
    out = {"schema": str(d / "schema.json"), "rows": rows}
    for name, kw in (("plain", {}), ("blank", {"blank_lines": True}),
                     ("no-final-newline", {"final_newline": False}),
                     ("blank-no-final-newline",
                      {"blank_lines": True, "final_newline": False})):
        (d / f"{name}.csv").write_text(_text(rows, **kw))
        out[name] = str(d / f"{name}.csv")
    return out


def _encoders(schema_path):
    with open(schema_path) as fh:
        text = fh.read()
    return (DatasetEncoder(FeatureSchema.from_json(text)),
            JaxEncoder(JaxSchema.from_json(text)))


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for (gx, gv, gy, gn), (wx, wv, wy, wn) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gv.dtype == wv.dtype == np.float64
        # bit for bit, not merely equal: -0.0 and NaN payloads included
        np.testing.assert_array_equal(gv.view(np.int64), wv.view(np.int64))


def _assert_vocabs_equal(enc, other):
    assert set(enc.vocabs) == set(other.vocabs)
    for o in enc.vocabs:
        assert enc.vocabs[o].values == other.vocabs[o].values, o
    assert enc.class_vocab.values == other.class_vocab.values


@pytest.fixture
def mt_forced(monkeypatch):
    """The pthread encode on every buffer, with real threads, in both
    packages."""
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "MT_MIN_BYTES", 1)
        monkeypatch.setattr(mod, "MT_THREADS", 3)


def test_native_source_is_the_reference_copy():
    with open(os.path.join(REPO, "avenir_tpu", "native", "csv_ingest.c"),
              "rb") as fh:
        ref = fh.read()
    assert native.SRC.read_bytes() == ref


@pytest.mark.parametrize("name", ["plain", "blank", "no-final-newline",
                                  "blank-no-final-newline"])
@pytest.mark.parametrize("parse_threads", [1, 4])
@pytest.mark.parametrize("chunking", [{"chunk_rows": 700},
                                      {"chunk_bytes": 20000}],
                         ids=["rows", "bytes"])
def test_chunked_encode_matches_reference_and_numpy(inputs, mt_forced, name,
                                                    parse_threads, chunking):
    path = inputs[name]
    enc, jenc = _encoders(inputs["schema"])
    native.reset_call_counts()
    got = list(enc.encode_path_chunks(path, ",", parse_threads=parse_threads,
                                      **chunking))
    assert native.ENCODE_CALLS == len(got) > 3
    want = [tuple(c) for c in jenc.encode_path_chunks(
        path, ",", parse_threads=parse_threads, **chunking)]
    _assert_chunks_equal(got, want)
    _assert_vocabs_equal(enc, jenc)
    penc, _ = _encoders(inputs["schema"])
    plain = list(penc.plain_encode_path_chunks(path, ",", **chunking))
    _assert_chunks_equal(got, plain)
    _assert_vocabs_equal(enc, penc)
    assert sum(c[3] for c in got) == len(inputs["rows"])
    # negative bins stay raw (unshifted) in the chunks
    assert min(int(c[0][:, 1].min()) for c in got) < 0


@pytest.mark.parametrize("parse_threads", [1, 4])
def test_start_offset_and_offsets_match_reference(inputs, parse_threads):
    path = inputs["blank"]
    enc, jenc = _encoders(inputs["schema"])
    full = list(enc.encode_path_chunks(path, ",", chunk_rows=500,
                                       with_offsets=True,
                                       parse_threads=parse_threads))
    offset = full[2][5]
    enc2, jenc2 = _encoders(inputs["schema"])
    # the vocabularies a resumed scan carries: those after chunk 2
    for e in (enc2, jenc2):
        gen = e.encode_path_chunks(path, ",", chunk_rows=500)
        for _ in range(3):
            next(gen)
        gen.close()
    got = list(enc2.encode_path_chunks(path, ",", chunk_rows=500,
                                       start_offset=offset,
                                       with_offsets=True,
                                       parse_threads=parse_threads))
    want = list(jenc2.encode_path_chunks(path, ",", chunk_rows=500,
                                         start_offset=offset,
                                         with_offsets=True,
                                         parse_threads=parse_threads))
    assert [c[4:] for c in got] == [tuple(c[4:]) for c in want] \
        == [c[4:] for c in full[3:]]
    _assert_chunks_equal([c[:4] for c in got], [tuple(c[:4]) for c in want])


@pytest.mark.parametrize("name", ["blank", "no-final-newline"])
def test_one_shot_encode_matches_reference_and_numpy(inputs, mt_forced,
                                                     name):
    path = inputs[name]
    enc, jenc = _encoders(inputs["schema"])
    native.reset_call_counts()
    ds = enc.encode_path(path, ",")
    assert native.ENCODE_CALLS == 1
    jds = jenc.encode_path(path, ",")
    penc, _ = _encoders(inputs["schema"])
    pds = penc.encode(read_field_matrix(path, ","))
    for other in (jds, pds):
        np.testing.assert_array_equal(ds.x, other.x)
        np.testing.assert_array_equal(ds.y, other.y)
        np.testing.assert_array_equal(ds.values.view(np.int64),
                                      other.values.view(np.int64))
        np.testing.assert_array_equal(ds.bin_offset, other.bin_offset)
        assert list(ds.num_bins) == list(other.num_bins)
    assert int(ds.bin_offset[1]) < 0
    _assert_vocabs_equal(enc, jenc)
    _assert_vocabs_equal(enc, penc)


@pytest.mark.parametrize("name", ["blank", "no-final-newline"])
def test_buffer_chunk_encode_matches_reference(inputs, mt_forced, name):
    """The per-chunk step on caller-owned buffers: the same chunks, fed in
    order with shared vocabularies, as the reference's buffer encode,
    including a chunk of blank lines only."""
    with open(inputs[name], "rb") as fh:
        lines = fh.read().split(b"\n")
    bufs = [b"\n".join(lines[i:i + 600]) for i in range(0, len(lines), 600)]
    bufs.insert(2, b"\n\n")
    enc, jenc = _encoders(inputs["schema"])
    native.reset_call_counts()
    got = [enc.encode_buffer_chunk(b, ",") for b in bufs]
    assert native.ENCODE_CALLS == len(bufs) - 1
    want = [tuple(jenc.encode_buffer_chunk(b, ",")) for b in bufs]
    _assert_chunks_equal(got, want)
    _assert_vocabs_equal(enc, jenc)
    assert got[2][3] == 0 and got[2][0].shape == (0, 4)
    assert sum(c[3] for c in got) == len(inputs["rows"])
    assert enc.encode_buffer_chunk(bufs[0], "[,;]") is None
    assert jenc.encode_buffer_chunk(bufs[0], "[,;]") is None


def test_rows_hint_matches_reference():
    for chunk in (b"", b"a\n", b"a\nb", b"a\n\nb\n", b"\na\n", b"a,b\nc,d\n"):
        assert _rows_hint(chunk) == jax_rows_hint(chunk)


def test_input_fallbacks_raise_unsupported(inputs, tmp_path):
    enc, _ = _encoders(inputs["schema"])
    with pytest.raises(ChunkedEncodeUnsupported, match="regex"):
        list(enc.encode_path_chunks(inputs["plain"], "[,;]"))
    ragged = tmp_path / "ragged.csv"
    ragged.write_text(_text(inputs["rows"][:50]) + "x1,red,3\n")
    with pytest.raises(ChunkedEncodeUnsupported, match="native encode"):
        list(enc.encode_path_chunks(str(ragged), ","))


def test_failed_build_raises_and_training_does_not_fall_back(
        inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILERS", ("no-such-compiler-cc",))
    with pytest.raises(native.NativeBuildError, match="no-such-compiler-cc"):
        native.get_lib()
    cfg = JobConfig({"feature.schema.file.path": CHURN_SCHEMA})
    with pytest.raises(native.NativeBuildError):
        tb.BayesianDistribution(cfg, device="cpu").run(
            inputs["plain"], str(tmp_path / "model"))
    assert not os.path.exists(tmp_path / "model")


def test_parse_pool_keeps_order_and_raises_in_place():
    def fn(i):
        if i == 5:
            raise ValueError("five")
        return i * i

    assert list(OrderedParsePool(fn, 3).map(range(5))) == [0, 1, 4, 9, 16]
    got = []
    with pytest.raises(ValueError, match="five"):
        for v in OrderedParsePool(fn, 4).map(range(9)):
            got.append(v)
    assert got == [0, 1, 4, 9, 16]
    assert parse_threads_from_config(JobConfig({})) == 1
    assert parse_threads_from_config(
        JobConfig({"ingest.parse.threads": "0"})) >= 1
    with pytest.raises(ValueError):
        parse_threads_from_config(JobConfig({"ingest.parse.threads": "-1"}))


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    """2,400 churn rows with a blank line and no final newline, and the
    reference's model of them."""
    from avenir_tpu_torch import datagen
    d = tmp_path_factory.mktemp("churn_native")
    assert datagen.main(["telecom_churn", "2400", "--seed", "29",
                         "--out", str(d / "all.csv")]) == 0
    lines = (d / "all.csv").read_text().splitlines()
    lines.insert(1000, "")
    (d / "in.csv").write_text("\n".join(lines))
    jb.BayesianDistribution(JaxConfig(
        {"feature.schema.file.path": CHURN_SCHEMA,
         "pipeline.chunk.rows": "300"})).run(str(d / "in.csv"),
                                             str(d / "model_jax"))
    return d


def _model(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("chunk", ["-Dpipeline.chunk.rows=300", None],
                         ids=["row-chunks", "byte-chunks"])
def test_cli_model_byte_identical(churn, tmp_path, threads, chunk):
    out = str(tmp_path / "model")
    argv = ["BayesianDistribution",
            f"-Dfeature.schema.file.path={CHURN_SCHEMA}",
            f"-Dingest.parse.threads={threads}",
            str(churn / "in.csv"), out, "--device", "cpu"]
    if chunk:
        argv.insert(1, chunk)
    native.reset_call_counts()
    assert cli_main(argv) == 0
    assert native.ENCODE_CALLS >= (8 if chunk else 1)
    assert _model(out) == _model(churn / "model_jax")


def test_one_shot_training_lines_identical(churn):
    cfg = {"feature.schema.file.path": CHURN_SCHEMA}
    enc, jenc = _encoders(CHURN_SCHEMA)
    path = str(churn / "in.csv")
    got = tb.BayesianDistribution(JobConfig(cfg), device="cpu").train_lines(
        enc.encode_path(path, ","), ",", tb.Counters())
    want = jb.BayesianDistribution(JaxConfig(cfg)).train_lines(
        jenc.encode_path(path, ","), ",", jb.Counters())
    assert got == want
