"""The port's native C ingest held against the JAX package's and against
the port's own numpy encoder, on the CPU.

The port's one schema encode (``native/chunk_encode.c``) takes every
chunk, every buffer and the one-shot encode with its id column.  The
chunked and one-shot encodes must give the same ``x``, ``values`` (bit
for bit), ``y``, ids, row counts, chunking and vocabulary order as the
reference's native encode, with its pthread encode forced on, and as the
port's numpy encoder, at ``ingest.parse.threads`` 1 and 4; inputs carry
blank lines, a missing final newline and negative bins.  The port's one
chunk reader (``pipeline.iter_byte_chunks_meta``) cuts the reference's
chunks, in row and byte mode, from a resume offset and under a fault
plan.  Models trained through the port's CLI are byte-identical to the
reference's.

The encode is held bit for bit against the reference's native encode and
the numpy encoder on its own inputs too: CRLF ends, blank lines only,
integer and other text in a float column, rejected rows and their
salvage, a vocabulary past ``max_uniq``, and a row capacity the rows
overflow.
"""

import ctypes
import json
import os

import numpy as np
import pytest

from avenir_tpu import native as jnative
from avenir_tpu.core.binning import DatasetEncoder as JaxEncoder
from avenir_tpu.core.binning import _rows_hint as jax_rows_hint
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.resilience import RowQuarantine as JaxQuarantine
from avenir_tpu.core.resilience import salvage_chunk as jax_salvage_chunk
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
from avenir_tpu_torch.core.resilience import RowQuarantine, salvage_chunk
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
    # ids of 2 to 7 bytes: the fixed-width id column pads the short ones
    short = [[r[0][:2 + i % 6]] + r[1:] for i, r in enumerate(rows)]
    (d / "short-ids.csv").write_text(_text(short, blank_lines=True))
    out["short-ids"] = str(d / "short-ids.csv")
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
    """The reference's pthread encode on every buffer, with real threads:
    the oracle the port's one-thread encode is held against."""
    monkeypatch.setattr(jnative, "MT_MIN_BYTES", 1)
    monkeypatch.setattr(jnative, "MT_THREADS", 3)


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


@pytest.mark.parametrize("name", ["blank", "no-final-newline", "short-ids"])
def test_one_shot_encode_matches_reference_and_numpy(inputs, mt_forced,
                                                     name):
    path = inputs[name]
    enc, jenc = _encoders(inputs["schema"])
    native.reset_call_counts()
    ds = enc.encode_path(path, ",")
    assert native.ENCODE_CALLS == 1
    jds = jenc.encode_path(path, ",")
    # the ids, byte for byte, in the reference's fixed-width array
    assert ds.ids_raw.dtype == jds.ids_raw.dtype
    assert ds.ids_raw.tobytes() == jds.ids_raw.tobytes()
    penc, _ = _encoders(inputs["schema"])
    pds = penc.encode(read_field_matrix(path, ","))
    assert ds.ids == jds.ids == pds.ids
    assert len(set(map(len, ds.ids))) == (6 if name == "short-ids" else 1)
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


# -- the one-pass chunk encode -------------------------------------------

# text a float column must read as strtod does: integer text converts
# exactly, the rest goes through strtod
FLOAT_TEXT = ["-0", "+7", "007", " 12 ", "12\t", "0", "-3",
              "123456789012345", "-999999999999999", "1234567890123456",
              "12345678901234567", "3.25", "-0.5", "1e5", "2.5E-3", "inf",
              "-inf", "nan"]


def _float_text_rows(rows):
    return [r[:3] + [FLOAT_TEXT[i % len(FLOAT_TEXT)]] + r[4:]
            for i, r in enumerate(rows)]


# the one pass's fast forms at their edges: 8- and 9-digit and 32-bit
# boundary bins, keys of 8 bytes and more, a bucket width of 1
EDGE_SCHEMA = {"fields": [dict(f, bucketWidth=1) if f["name"] == "visits"
                          else f for f in SCHEMA["fields"]]}
EDGE_TEXT = {
    1: ["abcdefgh", "abcdefghi", "a", "red", "abcdefghijklmnop", "abcdefgi",
        "green"],
    2: ["-99999999", "99999999", "123456789", "-123456789", "2147483648",
        "-2147483648", "2147483647", "-2147483649", "+5", " 3", "3 ", "0",
        "-0", "007", "12345678", "-7", "6"],
    4: ["0", "1", "-5", "59", "123456", "99999999", "-2147483648"],
}


def _edge_rows(rows):
    out = []
    for i, r in enumerate(rows):
        r = list(r)
        for col, texts in EDGE_TEXT.items():
            r[col] = texts[(i * (col + 2)) % len(texts)]
        r[3] = FLOAT_TEXT[i % len(FLOAT_TEXT)]
        out.append(r)
    return out


@pytest.fixture(scope="module")
def one_pass_inputs(inputs):
    """Buffers of SCHEMA's six columns, each with the text the numpy
    encoder reads as the same rows (CRLF ends read as LF ends)."""
    out = {}
    for name in ("plain", "blank", "no-final-newline",
                 "blank-no-final-newline"):
        with open(inputs[name], "rb") as fh:
            out[name] = fh.read()
    plain = out["plain"]
    out["crlf"] = plain.replace(b"\n", b"\r\n")
    out["leading-blank"] = b"\n" + plain
    out["blank-only"] = b"\n\n\n"
    out["float-text"] = _text(_float_text_rows(inputs["rows"])).encode()
    out["edge-text"] = _text(_edge_rows(inputs["rows"])).encode()
    return out


@pytest.fixture(scope="module")
def edge_schema(tmp_path_factory):
    path = tmp_path_factory.mktemp("edge") / "schema.json"
    path.write_text(json.dumps(EDGE_SCHEMA))
    return str(path)


def _specs(enc, n_cols=6):
    specs, _ = enc._specs_for_cols(n_cols)
    return specs


def _float_cols(enc):
    return [j for j, f in enumerate(enc.feature_fields)
            if not (f.is_categorical() or f.is_bucket_width_defined())]


def _assert_raw_equal(enc, got, want):
    """The port's one pass against the reference's native encode: the
    same rows, codes, uniques and value bits; the one pass writes -1 into
    a float column's ``x`` itself, where the reference's encode leaves 0
    for the caller's remap to fill."""
    gn, gx, gv, gy, _, gu = got
    wn, wx, wv, wy, _, wu = want
    assert gn == wn == len(gx) == len(gv) == len(gy)
    floats = _float_cols(enc)
    assert (gx[:, floats] == -1).all() and (wx[:, floats] == 0).all()
    wx = wx.copy()
    wx[:, floats] = -1
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gv.view(np.int64), wv.view(np.int64))
    assert gu == wu


@pytest.mark.parametrize("name", ["plain", "blank", "no-final-newline",
                                  "blank-no-final-newline", "crlf",
                                  "leading-blank", "blank-only",
                                  "float-text", "edge-text"])
def test_one_pass_matches_reference_and_numpy(inputs, one_pass_inputs,
                                              edge_schema, tmp_path, name):
    buf = one_pass_inputs[name]
    schema = edge_schema if name == "edge-text" else inputs["schema"]
    enc, _ = _encoders(schema)
    F = len(enc.feature_fields)
    native.reset_call_counts()
    got = native.encode_schema_buffer(buf, _specs(enc), 6, F, True)
    assert native.ENCODE_CALLS == 1
    want = jnative.encode_schema_buffer(buf, _specs(enc), 6, F, True)
    _assert_raw_equal(enc, got, want)
    # the numpy encoder over the same rows, through the remap
    path = tmp_path / "in.csv"
    path.write_bytes(buf.replace(b"\r\n", b"\n"))
    penc, _ = _encoders(schema)
    plain = list(penc.plain_encode_path_chunks(str(path), ",",
                                               chunk_bytes=1 << 30))
    n, x, values, y = enc._remap_native(got)
    _assert_chunks_equal([(x, values, y, n)], plain)
    _assert_vocabs_equal(enc, penc)
    if name == "blank-only":
        assert n == 0 and x.shape == (0, F)
    else:
        assert n == len(inputs["rows"])
        assert int(x[:, 1].min()) < 0           # negative bins, raw
    if name == "float-text":
        got_text = {t: values[i, 2] for i, t in
                    enumerate(FLOAT_TEXT)}
        assert np.signbit(got_text["-0"]) and got_text["-0"] == 0
        assert got_text["12345678901234567"] == 12345678901234568.0


def test_one_pass_vocabulary_overflow_retries(inputs, tmp_path):
    """70,000 distinct colours pass ``max_uniq`` (65,536): the one pass
    returns -3 and its one retry at 1 << 22 gives the reference's
    answer."""
    rows = [[f"id{i}", f"v{i}", str(i % 200 - 100), "1.5", str(i % 60),
             "Y" if i % 3 else "N"] for i in range(70_000)]
    buf = _text(rows).encode()
    enc, _ = _encoders(inputs["schema"])
    F = len(enc.feature_fields)
    native.reset_call_counts()
    got = native.encode_schema_buffer(buf, _specs(enc), 6, F, True)
    assert native.ENCODE_CALLS == 2
    want = jnative.encode_schema_buffer(buf, _specs(enc), 6, F, True)
    _assert_raw_equal(enc, got, want)
    assert len(got[5][1]) == 70_000
    path = tmp_path / "in.csv"
    path.write_bytes(buf)
    penc, _ = _encoders(inputs["schema"])
    plain = list(penc.plain_encode_path_chunks(str(path), ",",
                                               chunk_bytes=1 << 30))
    n, x, values, y = enc._remap_native(got)
    _assert_chunks_equal([(x, values, y, n)], plain)
    _assert_vocabs_equal(enc, penc)


# a line the native encoders reject, put into the churn input at line 500
BAD_LINES = {
    "unparseable": "x1,planA,12a,300,2,3,4,N",
    "float-junk": "x1,planA,1200,300,2,3,4.5.1,N",
    "short": "x1,planA,1200,300",
    "long": "x1,planA,1200,300,2,3,4,N,extra",
}


@pytest.mark.parametrize("bad", sorted(BAD_LINES))
def test_one_pass_rejects_and_salvages_as_reference(churn, tmp_path, bad):
    lines = (churn / "in.csv").read_text().split("\n")
    lines.insert(500, BAD_LINES[bad])
    path = tmp_path / "in.csv"
    path.write_text("\n".join(lines))
    enc, jenc = _encoders(CHURN_SCHEMA)
    specs = _specs(enc, 8)
    F = len(enc.feature_fields)
    buf = path.read_bytes()
    native.reset_call_counts()
    assert native.encode_schema_buffer(buf, specs, 8, F, True) is None
    assert native.ENCODE_CALLS == 1
    assert jnative.encode_schema_buffer(buf, specs, 8, F, True) is None
    with pytest.raises(ChunkedEncodeUnsupported, match="native encode"):
        list(enc.encode_path_chunks(str(path), ",", chunk_rows=300))
    enc, jenc = _encoders(CHURN_SCHEMA)
    q = RowQuarantine(str(tmp_path / "q"), "5")
    jq = JaxQuarantine(str(tmp_path / "jq"), "5")
    got = list(enc.encode_path_chunks(str(path), ",", chunk_rows=300,
                                      salvage=salvage_chunk(enc, q, ",")))
    want = [tuple(c) for c in jenc.encode_path_chunks(
        str(path), ",", chunk_rows=300,
        salvage=jax_salvage_chunk(jenc, jq, ","))]
    _assert_chunks_equal(got, want)
    _assert_vocabs_equal(enc, jenc)
    # the row guard keeps a long row's schema fields, as the reference's
    assert q.quarantined == jq.quarantined == (bad != "long")
    if q.quarantined:
        assert ((tmp_path / "q").read_text()
                == (tmp_path / "jq").read_text())
    assert sum(c[3] for c in got) == 2401 - q.quarantined


@pytest.mark.parametrize("name", ["blank", "blank-no-final-newline"])
@pytest.mark.parametrize("parse_threads", [1, 4])
@pytest.mark.parametrize("chunking", [{"chunk_rows": 700},
                                      {"chunk_bytes": 20000}],
                         ids=["rows", "bytes"])
def test_chunked_one_pass_matches_reference_and_numpy(
        inputs, name, parse_threads, chunking):
    """Every chunk takes the one pass at one and at four parse threads,
    sized by its line budget or, for byte chunks, by its length."""
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


def _c_args(enc, n_cols):
    """``chunk_encode``'s column arrays for ``enc``'s specs."""
    col_type, feat_idx, bucket_w = [0] * n_cols, [-1] * n_cols, [1] * n_cols
    for o, role, fj, extra in _specs(enc, n_cols):
        col_type[o], feat_idx[o] = role, fj
        if role == native.BUCKET:
            bucket_w[o] = extra
    return ((ctypes.c_int * n_cols)(*col_type),
            (ctypes.c_int * n_cols)(*feat_idx),
            (ctypes.c_longlong * n_cols)(*bucket_w))


@pytest.mark.parametrize("cap", [0, 1, 99])
def test_capacity_overflow_writes_nothing_past_it(inputs, cap):
    """Rows past the capacity return CHUNK_OVERFLOW before a cell past it
    is written, and the encode returns None, as for rows it rejects;
    the rows' own count as the capacity answers as the reference does."""
    rows = inputs["rows"][:100]
    buf = b"\n" + _text(rows).encode()
    enc, _ = _encoders(inputs["schema"])
    F = len(enc.feature_fields)
    lib = native.get_lib()
    x = np.full((cap + 8, F), -7, np.int32)
    values = np.full((cap + 8, F), 7.25)
    y = np.full(cap + 8, -7, np.int32)
    uniq_start = np.empty((2, 1 << 16), np.int64)
    uniq_len = np.empty((2, 1 << 16), np.int32)
    n_uniq = np.empty(2, np.int32)
    rc = lib.chunk_encode(buf, len(buf), b",", 6, *_c_args(enc, 6), F, cap,
                          x.ctypes.data, values.ctypes.data, y.ctypes.data,
                          uniq_start.ctypes.data, uniq_len.ctypes.data,
                          n_uniq.ctypes.data, 1 << 16, None, 0)
    assert rc == native.CHUNK_OVERFLOW
    assert (x[cap:] == -7).all() and (values[cap:] == 7.25).all()
    assert (y[cap:] == -7).all()
    native.reset_call_counts()
    assert native.encode_schema_buffer(buf, _specs(enc), 6, F, True,
                                       row_capacity=cap) is None
    assert native.ENCODE_CALLS == 1
    got = native.encode_schema_buffer(buf, _specs(enc), 6, F, True,
                                      row_capacity=100)
    want = jnative.encode_schema_buffer(buf, _specs(enc), 6, F, True)
    _assert_raw_equal(enc, got, want)
    assert got[0] == 100


@pytest.fixture(scope="module")
def churn_big(tmp_path_factory):
    """150,000 churn rows: three 65,536-row chunks."""
    from avenir_tpu_torch import datagen
    d = tmp_path_factory.mktemp("churn_big")
    assert datagen.main(["telecom_churn", "150000", "--seed", "31",
                         "--out", str(d / "in.csv")]) == 0
    return d


@pytest.mark.parametrize("route", ["one-pass", "pthreads", "one-shot"])
def test_one_pass_counter_counts_its_chunks(churn_big, tmp_path,
                                            monkeypatch, route):
    """A churn job at 65,536-row chunks makes one encode call a chunk; a
    buffer of 4 MB or more, which the reference fans out over pthreads,
    and the one-shot encode with its id column make one call each, at
    one thread."""
    path = str(churn_big / "in.csv")
    enc, jenc = _encoders(CHURN_SCHEMA)
    native.reset_call_counts()
    if route == "pthreads":
        buf = (churn_big / "in.csv").read_bytes()
        assert len(buf) >= 4 << 20
        monkeypatch.setattr(jnative, "MT_THREADS", 3)
        specs, F = _specs(enc, 8), len(enc.feature_fields)
        got = native.encode_schema_buffer(buf, specs, 8, F, True)
        assert native.ENCODE_CALLS == 1
        want = jnative.encode_schema_buffer(buf, specs, 8, F, True)
        _assert_raw_equal(enc, got, want)
        assert got[0] == 150_000
        return
    if route == "one-shot":
        ds = enc.encode_path(path, ",")
        assert ds.n_rows == 150_000
        assert native.ENCODE_CALLS == 1
        jds = jenc.encode_path(path, ",")
        np.testing.assert_array_equal(ds.x, jds.x)
        assert ds.ids_raw.tobytes() == jds.ids_raw.tobytes()
        return
    assert cli_main(["BayesianDistribution", "-Dpipeline.chunk.rows=65536",
                     f"-Dfeature.schema.file.path={CHURN_SCHEMA}", path,
                     str(tmp_path / "model"), "--device", "cpu"]) == 0
    assert native.ENCODE_CALLS == 3


@pytest.mark.parametrize("plan", [None, "corrupt@2"],
                         ids=["no-faults", "corrupt"])
@pytest.mark.parametrize("resume", [False, True],
                         ids=["from-start", "start-offset"])
@pytest.mark.parametrize("chunking", [{"chunk_rows": 300},
                                      {"chunk_bytes": 8000}],
                         ids=["rows", "bytes"])
def test_chunk_reader_cuts_the_reference_chunks(churn, tmp_path,
                                                monkeypatch, chunking,
                                                resume, plan):
    """The one chunk reader against the reference's chunked encode: the
    same raw chunks, after the fault plan, with the same chunk indices
    and end offsets, from the start and from a checkpointed offset."""
    from avenir_tpu.core import faultinject as jfi
    from avenir_tpu.core import pipeline as jpipeline
    from avenir_tpu_torch.core import faultinject, pipeline

    path = str(churn / "in.csv")
    _, jenc = _encoders(CHURN_SCHEMA)
    offset = 0
    if resume:
        offset = list(jenc.encode_path_chunks(path, ",", with_offsets=True,
                                              **chunking))[1][5]
    seen = {}
    real = jpipeline.chunk_faults

    def record(chunk, idx):
        seen[idx] = real(chunk, idx)
        return seen[idx]

    monkeypatch.setattr(jpipeline, "chunk_faults", record)
    try:
        if plan is not None:
            jfi.set_injector(jfi.FaultInjector(jfi.parse_plan(plan)))
            faultinject.set_injector(faultinject.FaultInjector(
                faultinject.parse_plan(plan)))
        _, jenc = _encoders(CHURN_SCHEMA)
        salvage = jax_salvage_chunk(
            jenc, JaxQuarantine(str(tmp_path / "jq"), "100"), ",")
        want = [(seen[c[4]], c[4], c[5]) for c in jenc.encode_path_chunks(
            path, ",", start_offset=offset, with_offsets=True,
            salvage=salvage, **chunking)]
        got = list(pipeline.iter_byte_chunks_meta(
            path, chunking.get("chunk_rows"), offset,
            chunk_bytes=chunking.get("chunk_bytes", 48 << 20)))
    finally:
        jfi.set_injector(None)
        faultinject.set_injector(None)
    assert got == want
    assert len(got) > 3
    assert got[0][1] == (2 if resume else 0)
    with open(path, "rb") as fh:
        buf = fh.read()
    pos = offset
    for chunk, idx, end in got:
        assert (chunk == buf[pos:end]) == (plan is None or idx != 2)
        pos = end
    assert pos == len(buf)
