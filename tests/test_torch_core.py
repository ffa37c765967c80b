"""The PyTorch port's copies of the JAX package's host modules held against
the originals, on the CPU: properties and CLI config, the chunk-size keys,
CSV reading and splitting, job output files, feature schemas, counters,
the confusion matrix and cost arbitration, and the column encoder (one
shot and chunked).  The port may not import these modules, so it keeps
copies; each test feeds the same input to both and requires equal results.
"""

import glob
import os

import numpy as np
import pytest

from avenir_tpu.core import binning as jbinning
from avenir_tpu.core import config as jconfig
from avenir_tpu.core import io as jio
from avenir_tpu.core import metrics as jmetrics
from avenir_tpu.core import pipeline as jpipeline
from avenir_tpu.core import schema as jschema
from avenir_tpu.datagen import gen_telecom_churn

from avenir_tpu_torch.core import binning, config, io, metrics, pipeline
from avenir_tpu_torch.core import schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHURN_SCHEMA = os.path.join(REPO, "resource", "churn_nb", "teleComChurn.json")
SCHEMAS = sorted(glob.glob(os.path.join(REPO, "resource", "*", "*.json")))


@pytest.mark.parametrize("text", [
    pytest.param("a=1\nb : 2\nc 3\n", id="separators"),
    pytest.param("# comment\n! bang\n\n  k.x = v w \n", id="comments-blanks"),
    pytest.param("long = one \\\n    two \\\n three\n", id="continuation"),
    pytest.param("a\\=b = c\nx\\:y: z\n", id="escaped-separators"),
    pytest.param("k == v\nempty=\nlonely\n", id="doubled-empty-lonely"),
    pytest.param("tail = x \\", id="continuation-at-eof"),
])
def test_parse_properties_matches_reference(text):
    assert config.parse_properties(text) == jconfig.parse_properties(text)


def test_cli_config_matches_reference(tmp_path):
    props = tmp_path / "job.properties"
    props.write_text("field.delim = ;\nbp.field.delim.out = |\n"
                     "bp.score.precision = float64\ntabular.input = TRUE\n"
                     "pipeline.chunk.rows = 512\n")
    argv = [f"-Dconf.path={props}", "-Dbp.pipeline.prefetch.depth=0",
            "-Dx=a=b", "in", "out", "-Dnovalue"]
    assert config.parse_cli_args(argv) == jconfig.parse_cli_args(argv)
    defines, _ = jconfig.parse_cli_args(argv)
    for prefix in ("", "bp"):
        got = config.load_job_config(defines, prefix)
        want = jconfig.load_job_config(defines, prefix)
        assert got.props == want.props
        for key in ("score.precision", "x", "missing"):
            assert got.get(key, "d") == want.get(key, "d")
        assert got.get_boolean("tabular.input") == want.get_boolean(
            "tabular.input")
        assert got.field_delim_regex() == want.field_delim_regex()
        assert got.field_delim_out() == want.field_delim_out()
        assert got.pipeline_chunk_rows() == want.pipeline_chunk_rows()
        assert got.pipeline_prefetch_depth() == want.pipeline_prefetch_depth()
        with pytest.raises(KeyError):
            got.must("missing")


@pytest.mark.parametrize("props,row_bytes,default", [
    pytest.param({"pipeline.chunk.rows": "1000"}, 28, None, id="explicit"),
    pytest.param({"pipeline.device.budget.bytes": "1000000"}, 28, None,
                 id="budget"),
    pytest.param({"pipeline.device.budget.bytes": "1000000",
                  "pipeline.prefetch.depth": "0"}, 28, None,
                 id="budget-serial"),
    pytest.param({}, 28, 4096, id="default"),
    pytest.param({"pipeline.device.budget.bytes": "1000000"}, None, 77,
                 id="budget-without-row-size"),
])
def test_chunk_rows_from_config_matches_reference(props, row_bytes, default):
    got = pipeline.chunk_rows_from_config(config.JobConfig(props),
                                          row_bytes=row_bytes,
                                          default=default)
    want = jpipeline.chunk_rows_from_config(jconfig.JobConfig(props),
                                            row_bytes=row_bytes,
                                            default=default)
    assert got == want
    assert (pipeline.prefetch_depth_from_config(config.JobConfig(props))
            == jpipeline.prefetch_depth_from_config(jconfig.JobConfig(props)))


@pytest.mark.parametrize("props", [
    pytest.param({"pipeline.chunk.rows": "0"}, id="zero-rows"),
    pytest.param({"pipeline.prefetch.depth": "-1"}, id="negative-depth"),
])
def test_chunk_config_rejects_what_the_reference_rejects(props):
    for cfg_mod, pipe in ((config, pipeline), (jconfig, jpipeline)):
        with pytest.raises(ValueError):
            pipe.chunk_rows_from_config(cfg_mod.JobConfig(props))
            pipe.prefetch_depth_from_config(cfg_mod.JobConfig(props))


@pytest.mark.parametrize("delim,lines", [
    pytest.param(",", ["a,b,c", "d,,f", ",,"], id="comma"),
    pytest.param("\t", ["a\tb", "c\td"], id="tab"),
    pytest.param(";|,", ["a;b,c", "d,e;f"], id="regex"),
    pytest.param(",", ["a,b", "c,d,e", "f"], id="ragged"),
    pytest.param(".", ["a.b", "c.d"], id="regex-metachar"),
])
def test_split_and_read_match_reference(tmp_path, delim, lines):
    d = tmp_path / "in"
    d.mkdir()
    (d / "part-00001").write_text("\n".join(lines[1:]) + "\n\n")
    (d / "part-00000").write_text(lines[0] + "\n")
    (d / "_SUCCESS").write_text("")
    (d / ".hidden").write_text("x,y\n")
    assert io.is_plain_delim(delim) == jio.is_plain_delim(delim)
    for line in lines:
        assert io.split_line(line, delim) == jio.split_line(line, delim)
    assert io._input_files(str(d)) == jio._input_files(str(d))
    assert list(io.read_lines(str(d))) == list(jio.read_lines(str(d)))
    assert (list(io.read_records(str(d), delim))
            == list(jio.read_records(str(d), delim)))
    got = io.read_field_matrix(str(d), delim)
    want = jio.read_field_matrix(str(d), delim)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_write_output_matches_reference(tmp_path):
    lines = ["N,1,planA,10", "Y,,,3", "", "x"]
    got = io.write_output(str(tmp_path / "port"), iter(lines))
    want = jio.write_output(str(tmp_path / "jax"), iter(lines))
    assert os.path.basename(got) == os.path.basename(want) == "part-r-00000"
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert os.path.exists(tmp_path / "port" / "_SUCCESS")
    assert os.path.exists(tmp_path / "jax" / "_SUCCESS")
    # a rewrite replaces the part file
    io.write_output(str(tmp_path / "port"), ["only"])
    assert list(io.read_lines(str(tmp_path / "port"))) == ["only"]


def _field_view(f):
    return (f.name, f.ordinal, f.dataType, f.feature, f.id, f.classAttr,
            f.cardinality, f.bucketWidth, f.min, f.max, f.splitScanInterval,
            f.maxSplit, f.extra, f.is_categorical(),
            f.is_bucket_width_defined())


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("path", SCHEMAS,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_schema_matches_reference(path):
    got = schema.FeatureSchema.from_file(path)
    want = jschema.FeatureSchema.from_file(path)
    assert [_field_view(f) for f in got.fields] == \
        [_field_view(f) for f in want.fields]
    assert ([f.ordinal for f in got.feature_fields()]
            == [f.ordinal for f in want.feature_fields()])
    assert (_outcome(lambda: got.id_field() and got.id_field().ordinal)
            == _outcome(lambda: want.id_field() and want.id_field().ordinal))
    assert (_outcome(lambda: got.class_attr_field().ordinal)
            == _outcome(lambda: want.class_attr_field().ordinal))
    for g, w in zip(got.feature_fields(), want.feature_fields()):
        assert _outcome(g.num_bins) == _outcome(w.num_bins)


def test_counters_confusion_and_arbitration_match_reference():
    rng = np.random.default_rng(8)
    classes = ["N", "Y"]
    got_c, want_c = metrics.Counters(), jmetrics.Counters()
    got_m = metrics.ConfusionMatrix("N", "Y")
    want_m = jmetrics.ConfusionMatrix("N", "Y")
    for _ in range(500):
        pred, actual = (classes[i] for i in rng.integers(0, 2, 2))
        got_m.report(pred, actual)
        want_m.report(pred, actual)
    got_m.to_counters(got_c)
    want_m.to_counters(want_c)
    for c in (got_c, want_c):
        c.incr("Job", "Rows", 7)
        c.set("Ingest", "Chunks", 3)
    assert got_c.as_dict() == want_c.as_dict()
    assert got_c.format() == want_c.format()
    got_a = metrics.CostBasedArbitrator("N", "Y", 5, 2)
    want_a = jmetrics.CostBasedArbitrator("N", "Y", 5, 2)
    for pos, neg in rng.integers(0, 101, (200, 2)):
        assert (got_a.arbitrate(int(pos), int(neg))
                == want_a.arbitrate(int(pos), int(neg)))


def _skewed_rows(n, seed):
    """Churn-shaped rows whose bucketed column goes negative and whose
    plan column has values no schema declares, first seen in a later
    chunk."""
    rng = np.random.default_rng(seed)
    rows = gen_telecom_churn(n, seed=seed)
    for i, r in enumerate(rows):
        r[2] = str(int(rng.integers(-900, 2200)))
        if i > n // 2 and rng.random() < 0.2:
            r[1] = f"plan{chr(ord('C') + int(rng.integers(0, 3)))}"
    return rows


@pytest.mark.parametrize("kind", ["churn", "negative-bins-late-categories"])
def test_encoder_matches_reference(tmp_path, kind):
    rows = (gen_telecom_churn(3000, seed=29) if kind == "churn"
            else _skewed_rows(3000, 6))
    path = tmp_path / "in.csv"
    path.write_text("\n".join(",".join(r) for r in rows) + "\n")
    sch_p = schema.FeatureSchema.from_file(CHURN_SCHEMA)
    sch_j = jschema.FeatureSchema.from_file(CHURN_SCHEMA)

    got = binning.DatasetEncoder(sch_p).encode_path(str(path))
    want = jbinning.DatasetEncoder(sch_j).encode_path(str(path))
    for name in ("x", "values", "y", "bin_offset", "binned_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.num_bins == want.num_bins
    assert ({k: v.values for k, v in got.vocabs.items()}
            == {k: v.values for k, v in want.vocabs.items()})
    assert got.class_vocab.values == want.class_vocab.values
    assert ([got.bin_label(j, b) for j in range(got.n_features)
             if got.binned_mask[j] for b in range(got.num_bins[j])]
            == [want.bin_label(j, b) for j in range(want.n_features)
                if want.binned_mask[j] for b in range(want.num_bins[j])])

    # chunked: the same per-chunk arrays, by rows and by bytes
    for kw in ({"chunk_rows": 700}, {"chunk_bytes": 20000}):
        enc_p = binning.DatasetEncoder(sch_p)
        enc_j = jbinning.DatasetEncoder(sch_j)
        got_chunks = list(enc_p.encode_path_chunks(str(path), ",", **kw))
        want_chunks = list(enc_j.encode_path_chunks(str(path), ",", **kw))
        assert len(got_chunks) == len(want_chunks) > 1
        for g, w in zip(got_chunks, want_chunks):
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
            assert g[3] == w[3]
        assert ({k: v.values for k, v in enc_p.vocabs.items()}
                == {k: v.values for k, v in enc_j.vocabs.items()})


def test_row_chunks_and_peek_match_reference():
    buf = b"a\nb\n\nc\nd\ne\nf"
    for rows in (1, 2, 3, 10):
        assert (pipeline.row_chunk_ends(buf, rows)
                == jpipeline.row_chunk_ends(buf, rows))
    for lines in (["a,b", "c,d"], ["a,b", "c"]):
        got, gbulk = pipeline.split_field_lines(lines, ",")
        want, wbulk = jpipeline.split_field_lines(lines, ",")
        assert gbulk == wbulk
        assert [list(r) for r in got] == [list(r) for r in want]
    for items in ([], [1], [1, 2, 3]):
        gfirst, git = pipeline.peek(iter(items))
        wfirst, wit = jpipeline.peek(iter(items))
        assert gfirst == wfirst and list(git) == list(wit) == items


# ---------------------------------------------------------------------------
# io.require.success: an unmarked input directory is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli_key", [False, True], ids=["api", "cli-config"])
def test_require_success_refuses_unmarked_inputs(tmp_path, cli_key):
    from avenir_tpu_torch.cli import configure_resilience

    d = tmp_path / "upstream"
    os.makedirs(d)
    (d / "part-r-00000").write_text("a,1\nb,2\n")
    conf = config.JobConfig({io.KEY_REQUIRE_SUCCESS: "true"})
    jconf = jconfig.JobConfig({jio.KEY_REQUIRE_SUCCESS: "true"})
    assert io.KEY_REQUIRE_SUCCESS == jio.KEY_REQUIRE_SUCCESS
    refused = lambda: io._durability_counters().get(     # noqa: E731
        "Durability", "Unmarked inputs refused")
    before = refused()
    try:
        if cli_key:
            configure_resilience(conf)
        else:
            io.configure_from_config(conf)
        jio.configure_from_config(jconf)
        with pytest.raises(io.TornArtifactError, match="_SUCCESS") as mine:
            list(io.read_lines(str(d)))
        with pytest.raises(jio.TornArtifactError) as theirs:
            list(jio.read_lines(str(d)))
        assert str(mine.value) == str(theirs.value)
        assert refused() == before + 1
        # a single file is not a job-output directory: no marker needed
        assert list(io.read_lines(str(d / "part-r-00000"))) == ["a,1", "b,2"]
        (d / "_SUCCESS").write_text("")
        assert list(io.read_lines(str(d))) == ["a,1", "b,2"]
        assert refused() == before + 1
    finally:
        io.set_require_success(False)
        jio.set_require_success(False)
    os.remove(d / "_SUCCESS")
    assert list(io.read_lines(str(d))) == ["a,1", "b,2"]     # default: off


def test_torn_input_part_is_refused_like_the_reference(tmp_path):
    """A job-output directory whose part no longer matches its
    ``_MANIFEST`` is refused on read, by both packages, with the same
    message."""
    out = str(tmp_path / "art")
    io.write_output(out, ["a,1", "b,2"])
    with open(os.path.join(out, "part-r-00000"), "a") as fh:
        fh.write("c,3\n")
    with pytest.raises(io.TornArtifactError) as mine:
        list(io.read_lines(out))
    with pytest.raises(jio.TornArtifactError) as theirs:
        list(jio.read_lines(out))
    assert str(mine.value).split(":")[0] == str(theirs.value).split(":")[0]
    assert "is 12 bytes but _MANIFEST records 8" in str(mine.value)


@pytest.mark.parametrize("argv", [
    ["telecom_churn", "40", "--seed", "5"], ["blobs", "30"],
    ["elearn", "200", "--seed", "3"], ["usage", "200", "--seed", "9"],
    ["transactions", "120", "60", "--seed", "17"],
    ["timed_transactions", "500", "60", "--seed", "37"],
    ["churn_state_seqs", "80", "--seed", "31"], ["hmm_seqs", "60", "--seed", "23"],
    ["hmm_obs", "40", "--seed", "67"], ["hmm_obs", "25"]],
    ids=lambda a: "-".join(a[:2]))
def test_datagen_presets_match_reference(tmp_path, argv):
    """Each preset of the port's ``datagen`` writes the reference
    command's bytes for the same arguments."""
    from avenir_tpu.datagen.cli import main as jax_datagen

    from avenir_tpu_torch import datagen

    for name, main in (("jax", jax_datagen), ("port", datagen.main)):
        assert main(argv + ["--out", str(tmp_path / name / "rows.csv")]) == 0
    with open(tmp_path / "port" / "rows.csv", "rb") as a, \
            open(tmp_path / "jax" / "rows.csv", "rb") as b:
        got = a.read()
        assert got == b.read()
    assert got.count(b"\n") == int(argv[1])


@pytest.mark.parametrize("argv", [["transactions", "10"], ["elearn", "1", "2"],
                                  ["nope", "3"], ["usage", "4", "--x", "1"]])
def test_datagen_refuses_what_the_reference_refuses(argv, capsys):
    from avenir_tpu.datagen.cli import main as jax_datagen

    from avenir_tpu_torch import datagen

    assert datagen.main(argv) == 2 == jax_datagen(argv)
    assert capsys.readouterr().out == ""


def test_line_and_field_chunk_readers_match_reference(tmp_path):
    lines = ["a,1,2", "", "b,3", "c,4,5", "d,6,7", "", "e,8,9"]
    os.makedirs(tmp_path / "in")
    with open(tmp_path / "in" / "part-00000", "w") as fh:
        fh.write("\n".join(lines[:4]) + "\n")
    with open(tmp_path / "in" / "part-00001", "w") as fh:
        fh.write("\n".join(lines[4:]) + "\n")
    for rows in (1, 2, 3, 10):
        got = list(pipeline.iter_line_chunks(str(tmp_path / "in"), rows))
        assert got == list(jpipeline.iter_line_chunks(str(tmp_path / "in"),
                                                      rows))
        for g, w in zip(pipeline.iter_field_chunks(str(tmp_path / "in"), ",",
                                                   rows),
                        jpipeline.iter_field_chunks(str(tmp_path / "in"), ",",
                                                    rows)):
            assert type(g) is type(w)
            assert np.asarray(g, dtype=object).tolist() == \
                np.asarray(w, dtype=object).tolist()
    with pytest.raises(ValueError):
        next(pipeline.iter_line_chunks(str(tmp_path / "in"), 0))


def test_streaming_fold_passes_broadcast_args():
    """``broadcast_args`` reach every fold after the mask, on the device,
    as the reference's do."""
    import torch

    seen = []

    def local(x, mask, table, scale, out=None):
        seen.append((mask, table.device.type))
        part = (table[x] * scale).sum(dim=0, keepdim=True)
        if out is None:
            return part
        out += part
        return out

    chunks = [(np.array([0, 1, 2]),), (np.array([2, 2]),)]
    got = pipeline.streaming_fold(iter(chunks), local, static_args=(3,),
                                  broadcast_args=(np.array([1, 10, 100]),),
                                  device=torch.device("cpu"),
                                  prefetch_depth=0)
    assert got.tolist() == [(1 + 10 + 100 + 200) * 3]
    assert seen == [(None, "cpu"), (None, "cpu")]
