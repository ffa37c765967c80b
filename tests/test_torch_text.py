"""The port's text jobs (``avenir_tpu_torch/models/text.py``: the
tokenizer and ``WordCounter``; Naive Bayes text mode in
``models/bayesian.py``) held against the JAX package's on the CPU.

``resource/word_count`` and ``resource/text_classify`` run through both
command lines on the same seeded rows; the tokenizer is held to the
reference's on cases of the reference's golden fixture and on non-ASCII
text; the NB text model and predictions are carried across packages
(each package's predictor on the other's model); the text-mode count is
K1's plain version at F = 1 over a wide vocabulary, against the
reference's Pallas kernel in interpret mode.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.datagen import gen_text_classified
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import bayesian as jb
from avenir_tpu.models import text as jtext
from avenir_tpu.ops.pallas_count import wide_feature_class_counts as jax_k1

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.models import bayesian as tb
from avenir_tpu_torch.models import text as ttext
from avenir_tpu_torch.ops import histogram
from avenir_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WC = os.path.join(REPO, "resource", "word_count")
TC = os.path.join(REPO, "resource", "text_classify")
CPU = torch.device("cpu")


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _runbooks(work, main, dg, extra=()):
    """resource/word_count/run.sh and resource/text_classify/run.sh with
    the working directory at their layout."""
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)

    def job(*argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(list(argv) + list(extra))
        assert rc in (0, None), err.getvalue()

    try:
        assert dg(["text_classified", "500", "--seed", "17",
                   "--out", "work/wc.csv"]) == 0
        with open("work/wc.csv") as fh:
            texts = [line.split(",")[0] for line in fh.read().splitlines()]
        write_output("work/in", texts)
        job("WordCounter", f"-Dconf.path={WC}/wc.properties", "work/in",
            "work/words")
        assert dg(["text_classified", "800", "--seed", "17",
                   "--out", "work/all.csv"]) == 0
        with open("work/all.csv") as fh:
            rows = fh.read().splitlines()
        write_output("work/train", rows[:600])
        write_output("work/test", rows[-200:])
        job("BayesianDistribution", f"-Dconf.path={TC}/nbtext.properties",
            "work/train", "work/model")
        job("BayesianPredictor", f"-Dconf.path={TC}/bptext.properties",
            "work/test", "work/pred")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_text")
    _runbooks(str(tmp / "jax"), jax_main, jax_datagen)
    _runbooks(str(tmp / "port"), port_main, datagen.main,
              extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("name", ["words", "model", "pred"])
def test_runbooks_byte_identical(runbooks, name):
    got = _read(runbooks / "port" / "work" / name)
    assert got == _read(runbooks / "jax" / "work" / name)
    assert got


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_text_model_carried_across_packages(runbooks, trained_by):
    """Each package's predictor on the other's model (and its own), with
    and without ``output.feature.prob.only``: the same lines."""
    model = str(runbooks / trained_by / "work" / "model")
    test = str(runbooks / "jax" / "work" / "test")
    for extra in ({}, {"output.feature.prob.only": "true"},
                  {"bp.predict.class": None}):
        props = {"tabular.input": "false", "bayesian.model.file.path": model,
                 "bp.predict.class": "N,P"}
        props.update(extra)
        props = {k: v for k, v in props.items() if v is not None}
        tag = f"{trained_by}{len(extra)}{sorted(extra)}"
        jb.BayesianPredictor(JaxConfig(dict(props), "bp")).run(
            test, str(runbooks / f"j{tag}"))
        tb.BayesianPredictor(JobConfig(dict(props), "bp"), device="cpu").run(
            test, str(runbooks / f"p{tag}"))
        assert _read(runbooks / f"p{tag}") == _read(runbooks / f"j{tag}")


GOLDEN_EXTRA = [
    "Crème brûlée, naïve café – déjà vu!",
    "Ünïcödé ñandú 3½ ４５６ x²",
    "東京タワーとスカイツリー は 高い",
    "ｶﾀｶﾅ・テスト ひらがな漢字",
    "Привет мир, это тест 123.45",
    "مرحبا بالعالم ١٢٣",
    "emoji 😀 text_with_under__score ‐ ‑ dash",
    "ﬁne ligatures and ǅ titlecase",
    "a" * 256 + " kept " + "b" * 255,
]


@pytest.mark.parametrize("text", GOLDEN_EXTRA + [
    "Don't stop believing", "john.smith's house",
    "pi is 3.14159 and 1,000,000 counts", "visit example.com or U.S.A.",
    "ratio a:b holds 1;2 but a;b", "foo_bar _lead trail_ ___",
    "mail foo@bar.com now", "x..z 1..2 x''z x.1 1.x"])
def test_tokenizer_matches_reference(text):
    assert ttext.standard_tokenize(text) == jtext.standard_tokenize(text)
    assert ttext._uax29_words(text) == jtext._uax29_words(text)


def test_tokenizer_tables_are_the_references():
    assert ttext.LUCENE_STOP_WORDS == jtext.LUCENE_STOP_WORDS
    assert ttext.MAX_TOKEN_LENGTH == jtext.MAX_TOKEN_LENGTH
    for ch in map(chr, range(0x20, 0x3100, 7)):
        assert ttext._char_class(ch) == jtext._char_class(ch), hex(ord(ch))


def test_word_counts_are_int64_on_a_mesh(tmp_path, mesh8):
    rows = [r[0] for r in gen_text_classified(300, seed=4)]
    write_output(str(tmp_path / "in"), rows)
    props = {"text.field.ordinal": "0"}
    jtext.WordCounter(JaxConfig(dict(props))).run(
        str(tmp_path / "in"), str(tmp_path / "j"), mesh=mesh8)
    ttext.WordCounter(JobConfig(dict(props)), device="cpu").run(
        str(tmp_path / "in"), str(tmp_path / "p"),
        mesh=pmesh.make_mesh([CPU] * 8, data=4, model=2))
    assert _read(tmp_path / "p") == _read(tmp_path / "j")
    ids = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    assert ttext._wc_local(ids, None, 3).dtype == torch.int64


@pytest.mark.parametrize("V,n", [(22, 4000), (40_000, 30_000)],
                         ids=["runbook-vocab", "cluster-route-vocab"])
def test_text_count_at_f1_matches_reference_kernel(V, n):
    """The text-mode count is K1 at F = 1 with one bin per token: its
    plain version against the reference's Pallas kernel (interpret
    mode), and the route K1 takes for that table on an H100."""
    rng = np.random.default_rng(V)
    x = rng.integers(0, V, (n, 1)).astype(np.int32)
    y = rng.integers(0, 2, n).astype(np.int32)
    want = np.asarray(jax_k1(x, y, 2, V, interpret=True))
    got = histogram.wide_feature_class_counts(torch.from_numpy(x),
                                              torch.from_numpy(y), 2, V)
    np.testing.assert_array_equal(got.numpy(), want)
    # an H100: 132 SMs, 227 KB of shared memory a block, 228 KB an SM
    plan = histogram.histogram_plan(n, 1, 2, V, 4, 132, 232_448, 233_472)
    assert histogram.ROUTES[plan.route] == ("block table" if V == 22
                                                  else "cluster")


def test_nb_text_training_needs_no_schema(runbooks):
    job = tb.BayesianDistribution(JobConfig({"tabular.input": "false"}),
                                  device="cpu")
    assert job.schema is None
    counters = job.run(str(runbooks / "jax" / "work" / "train"),
                       str(runbooks / "notext"))
    assert _read(runbooks / "notext") == _read(
        runbooks / "jax" / "work" / "model")
    assert counters.get("Distribution Data", "Class prior") > 0
