"""The port's Markov family (``avenir_tpu_torch/models/markov.py``) held
against the JAX package's on the CPU.

Every case of tests/test_markov.py runs through both packages on the same
seeded sequences (``avenir_tpu.datagen``), the reference's counts on its
8-device CPU mesh and the port's on one CPU device and on a mesh naming
the CPU eight times; model files, predictions and decoded states must be
byte-identical.  The ``resource/churn_markov`` and ``resource/hmm_viterbi``
steps run through both command lines.  The classifier is held on ratios
where ``torch.log`` and glibc's ``log`` disagree (the reference's float64
``log`` is glibc's), in float64 and float32, at every serving bucket's
padding; Viterbi on tables with planted ties; the trainer streamed and
warm off the pair cache.
"""

import contextlib
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avenir_tpu.cli import main as jax_main
from avenir_tpu.core.config import JobConfig as JaxConfig
from avenir_tpu.core.io import write_output
from avenir_tpu.core.tabular import (deserialize_matrix as j_deser,
                                     normalize_rows as j_norm,
                                     serialize_matrix as j_ser)
from avenir_tpu.datagen import gen_hmm_sequences, gen_state_sequences
from avenir_tpu.datagen.cli import main as jax_datagen
from avenir_tpu.models import markov as jm

from avenir_tpu_torch import datagen
from avenir_tpu_torch.cli import main as port_main
from avenir_tpu_torch.core import ingestcache
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.tabular import (deserialize_matrix,
                                           normalize_rows, serialize_matrix)
from avenir_tpu_torch.models import markov as tm
from avenir_tpu_torch.parallel import mesh as pmesh
from avenir_tpu_torch.serve.engine import pow2_buckets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHURN = os.path.join(REPO, "resource", "churn_markov")
HMM = os.path.join(REPO, "resource", "hmm_viterbi")
CPU = torch.device("cpu")
MESHES = ["cpu", "cpu-mesh8"]
STATES = ["LL", "LM", "LH", "ML", "MM", "MH", "HL", "HM", "HH"]


def _port_mesh(name):
    return None if name == "cpu" else pmesh.make_mesh([CPU] * 8)


def _read(path):
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def _chain(diag):
    S = len(STATES)
    T = np.full((S, S), (1 - diag) / (S - 1))
    np.fill_diagonal(T, diag)
    return T


def _both(job, props, inp, out, mesh8=None, port_mesh=None, **port_kw):
    """Run ``job`` (a class name) of each package; returns (jax, port)
    output bytes and counters."""
    jc = getattr(jm, job)(JaxConfig(dict(props))).run(
        str(inp), str(out) + "_jax", mesh=mesh8)
    pc = getattr(tm, job)(JobConfig(dict(props)), device="cpu",
                          **port_kw).run(str(inp), str(out) + "_port",
                                         mesh=port_mesh)
    return (_read(str(out) + "_jax"), _read(str(out) + "_port"), jc, pc)


@pytest.mark.parametrize("counts", [
    [[5, 0, 5], [2, 3, 5]], [[0, 0], [7, 1]], [[1]], [[3, 9, 27, 81]]])
@pytest.mark.parametrize("scale", [1000, 100, 1])
def test_transition_model_normalization_semantics(counts, scale):
    got = normalize_rows(np.asarray(counts), scale)
    want = j_norm(np.asarray(counts), scale)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert serialize_matrix(got) == j_ser(want)
    lines = serialize_matrix(got)
    np.testing.assert_array_equal(deserialize_matrix(lines, len(lines)),
                                  j_deser(lines, len(lines)))
    if scale == 1000 and counts[0] == [5, 0, 5]:
        assert got[0].tolist() == [461, 76, 461]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """tests/test_markov.py's classifier input: 600 sequences from a
    diagonal-heavy loyal chain and a hopping churner chain, seed 9."""
    tmp = tmp_path_factory.mktemp("torch_markov")
    rows = gen_state_sequences(600, STATES, {"L": _chain(0.6),
                                             "C": _chain(0.15)},
                               seq_len=(15, 40), seed=9)
    write_output(str(tmp / "train"), [",".join(r) for r in rows[:400]])
    write_output(str(tmp / "test"), [",".join(r) for r in rows[400:]])
    return tmp, rows


TRAIN_PROPS = {"model.states": ",".join(STATES), "class.label.field.ord": "1",
               "skip.field.count": "1", "trans.prob.scale": "1000"}


@pytest.mark.parametrize("mesh", MESHES)
def test_markov_train_and_classify(chains, mesh8, mesh):
    tmp, _ = chains
    want, got, jc, pc = _both("MarkovStateTransitionModel", TRAIN_PROPS,
                              tmp / "train", tmp / f"model_{mesh}", mesh8,
                              _port_mesh(mesh))
    assert got == want
    assert pc.get("Markov", "Transitions") == jc.get("Markov", "Transitions")
    model = tm.MarkovModel.load(str(tmp / f"model_{mesh}_port"), True)
    tl = model.class_trans["L"]
    assert np.mean(np.diag(tl)) > np.mean(tl) * 2
    for precision in ("float64", "float32"):
        props = {"mm.model.path": str(tmp / f"model_{mesh}_jax"),
                 "class.label.based.model": "true", "class.labels": "L,C",
                 "validation.mode": "true", "class.label.field.ord": "1",
                 "skip.field.count": "1", "mmc.score.precision": precision}
        want, got, jc, pc = _both("MarkovModelClassifier", props,
                                  tmp / "test", tmp / f"pred_{mesh}{precision}")
        assert got == want, precision
        for name in ("Correct", "Incorrect"):
            assert pc.get("Validation", name) == jc.get("Validation", name)
        correct = pc.get("Validation", "Correct")
        assert correct / (correct + pc.get("Validation", "Incorrect")) > 0.9


def _viterbi_oracle(obs, trans, emit, initial):
    """Scalar max-product Viterbi with the reference's strict-greater /
    first-index tie rule (tests/test_markov.py)."""
    T, S = len(obs), trans.shape[0]
    path = np.zeros((T, S))
    ptr = np.zeros((T, S), dtype=int)
    path[0] = initial * emit[:, obs[0]]
    for t in range(1, T):
        for s in range(S):
            best, bi = 0.0, 0
            for p in range(S):
                v = path[t - 1, p] * trans[p, s]
                if v > best:
                    best, bi = v, p
            path[t, s] = best * emit[s, obs[t]]
            ptr[t, s] = bi
    best, bi = 0.0, -1
    for s in range(S):
        if path[T - 1, s] > best:
            best, bi = path[T - 1, s], s
    seq = [bi]
    for t in range(T - 1, 0, -1):
        bi = ptr[t, bi]
        seq.append(bi)
    return seq[::-1]


def _port_viterbi(obs, lengths, trans, emit, initial):
    return tm.viterbi_batch(
        torch.from_numpy(obs), torch.from_numpy(lengths),
        *(torch.from_numpy(tm.host_log(t)) for t in (trans, emit, initial))
    ).numpy()


def _jax_viterbi(obs, lengths, trans, emit, initial):
    return np.asarray(jax.jit(jm.viterbi_batch)(
        jnp.asarray(obs), jnp.asarray(lengths), jnp.asarray(trans),
        jnp.asarray(emit), jnp.asarray(initial)))


def _obs_batch(rng, lengths, O):
    obs = np.full((len(lengths), int(max(lengths))), -1, dtype=np.int32)
    for i, L in enumerate(lengths):
        obs[i, :L] = rng.integers(0, O, L)
    return obs


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_viterbi_batch_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    S, O = 4, 6
    trans = rng.dirichlet(np.ones(S), S)
    emit = rng.dirichlet(np.ones(O), S)
    initial = rng.dirichlet(np.ones(S))
    lengths = np.array([7, 3, 12, 1, 12], dtype=np.int32)
    obs = _obs_batch(rng, lengths, O)
    got = _port_viterbi(obs, lengths, trans, emit, initial)
    np.testing.assert_array_equal(
        got, _jax_viterbi(obs, lengths, trans, emit, initial))
    for i, L in enumerate(lengths):
        assert got[i, :L].tolist() == _viterbi_oracle(obs[i, :L], trans,
                                                      emit, initial), i
        assert (got[i, L:] == -1).all()


@pytest.mark.parametrize("tables", ["uniform", "scaled-ints", "zeros"])
def test_viterbi_planted_ties(tables):
    """Equal candidates at every step (uniform tables), the scaled-int
    tables of a model file with repeated values, and zero cells (log 0 =
    -inf, whole rows of -inf): the first maximum wins, as in the
    reference."""
    rng = np.random.default_rng(11)
    S, O = 5, 4
    if tables == "uniform":
        trans, emit, initial = (np.full((S, S), 200.0), np.full((S, O), 250.0),
                                np.full(S, 20.0))
    elif tables == "scaled-ints":
        trans = rng.choice([100.0, 200.0, 300.0], (S, S))
        emit = rng.choice([250.0, 500.0], (S, O))
        initial = rng.choice([20.0, 40.0], S)
    else:
        trans = rng.choice([0.0, 500.0], (S, S))
        trans[:, 0] = 0.0
        emit = rng.choice([0.0, 250.0, 500.0], (S, O))
        emit[2] = 0.0
        initial = np.array([0.0, 50.0, 0.0, 50.0, 0.0])
    lengths = rng.integers(1, 14, 40).astype(np.int32)
    obs = _obs_batch(rng, lengths, O)
    got = _port_viterbi(obs, lengths, trans, emit, initial)
    np.testing.assert_array_equal(
        got, _jax_viterbi(obs, lengths, trans, emit, initial))
    if tables == "uniform":
        assert (got[got >= 0] == 0).all()


@pytest.fixture(scope="module")
def hmm_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hmm")
    A = np.array([[.7, .2, .1], [.1, .7, .2], [.2, .1, .7]])
    B = np.array([[.7, .1, .1, .1], [.1, .7, .1, .1], [.1, .1, .1, .7]])
    pi = np.array([.5, .3, .2])
    names = (["s0", "s1", "s2"], ["a", "b", "c", "d"])
    rows = gen_hmm_sequences(400, *names, A, B, pi, seed=5)
    write_output(str(tmp / "train"), [",".join(r) for r in rows])
    test = gen_hmm_sequences(50, *names, A, B, pi, seed=77)
    write_output(str(tmp / "obs"), [",".join(
        [r[0]] + [p.split(":")[0] for p in r[1:]]) for r in test])
    return tmp, names, A, [[p.split(":")[1] for p in r[1:]] for r in test]


@pytest.mark.parametrize("mesh", MESHES)
def test_hmm_build_and_decode(hmm_data, mesh8, mesh):
    tmp, (S_NAMES, O_NAMES), A, truth = hmm_data
    props = {"model.states": ",".join(S_NAMES),
             "model.observations": ",".join(O_NAMES),
             "skip.field.count": "1", "trans.prob.scale": "1000"}
    want, got, jc, pc = _both("HiddenMarkovModelBuilder", props,
                              tmp / "train", tmp / f"hmm_{mesh}", mesh8,
                              _port_mesh(mesh))
    assert got == want
    for name in ("Transitions", "Emissions"):
        assert pc.get("HMM", name) == jc.get("HMM", name)
    model = tm.HiddenMarkovModel.load(str(tmp / f"hmm_{mesh}_port"))
    est = model.trans / model.trans.sum(axis=1, keepdims=True)
    assert np.abs(est - A).max() < 0.08
    for state_only in ("true", "false"):
        vprops = {"hmm.model.path": str(tmp / f"hmm_{mesh}_jax"),
                  "skip.field.count": "1", "output.state.only": state_only}
        want, got, _, pc = _both("ViterbiStatePredictor", vprops,
                                 tmp / "obs", tmp / f"dec_{mesh}{state_only}")
        assert got == want
    assert pc.get("Viterbi", "Decoded") == 50
    lines = _read(str(tmp / f"dec_{mesh}true_port")).decode().splitlines()
    hits = sum(g == t for line, tr in zip(lines, truth)
               for g, t in zip(line.split(",")[1:], tr))
    assert hits / sum(len(t) for t in truth) > 0.7


@pytest.mark.parametrize("rows", [["a,X,b,b,Y,a"],
                                  ["X,a,b,Y", "a,a,Y,b,X,b,a", "b,X,a,a,b,Y,b",
                                   "a,b,X,a,b,a,b,a,Y,b", "X", "a,a"]])
def test_hmm_partially_tagged(tmp_path, rows):
    write_output(str(tmp_path / "in"), rows)
    props = {"model.states": "X,Y", "model.observations": "a,b",
             "partially.tagged": "true", "window.function": "3,2,1"}
    want, got, _, _ = _both("HiddenMarkovModelBuilder", props,
                            tmp_path / "in", tmp_path / "out")
    assert got == want
    model = tm.HiddenMarkovModel.load(str(tmp_path / "out_port"))
    assert model.trans.shape == (2, 2) and model.initial.shape == (2,)


# ---------------------------------------------------------------------------
# the classifier's float bits
# ---------------------------------------------------------------------------

def _differing_ratios(n):
    """(a, b) scaled ints whose float64 ratio's ``torch.log`` is not
    glibc's (``math.log``)."""
    a = np.arange(1, 1001, dtype=np.float64)
    out = []
    for b in range(1, 1001):
        r = a / b
        tl = torch.log(torch.from_numpy(r)).numpy()
        ml = np.asarray([math.log(v) for v in r])
        for i in np.flatnonzero(tl != ml):
            out.append((int(a[i]), b))
            if len(out) == n:
                return out
    raise AssertionError("no differing ratio found")


def _model_file(path, t0, t1, states):
    lines = [",".join(states), "classLabel:L"]
    lines += [",".join(str(int(v)) for v in row) for row in t0]
    lines += ["classLabel:C"] + [",".join(str(int(v)) for v in row)
                                 for row in t1]
    write_output(str(path), lines)


@pytest.fixture(scope="module")
def glibc_model(tmp_path_factory):
    """A three-state model whose every (from, to) ratio is one where
    ``torch.log`` is not glibc's ``log``, and 300 seeded sequences."""
    tmp = tmp_path_factory.mktemp("torch_mmc")
    pairs = _differing_ratios(9)
    t0 = np.array([p[0] for p in pairs], float).reshape(3, 3)
    t1 = np.array([p[1] for p in pairs], float).reshape(3, 3)
    states = ["A", "B", "C"]
    _model_file(tmp / "model", t0, t1, states)
    rng = np.random.default_rng(3)
    rows = [",".join([f"Q{i}"] + list(rng.choice(states, rng.integers(2, 70))))
            for i in range(300)]
    write_output(str(tmp / "seqs"), rows)
    return tmp, t0, t1, rows


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_classifier_scores_are_the_references_bits(glibc_model, precision):
    tmp, t0, t1, _ = glibc_model
    props = {"mm.model.path": str(tmp / "model"),
             "class.label.based.model": "true", "class.labels": "L,C",
             "mmc.score.precision": precision}
    want, got, _, _ = _both("MarkovModelClassifier", props, tmp / "seqs",
                            tmp / f"pred_{precision}")
    assert got == want
    lo = tm.log_ratio_table(t0, t1, precision)
    ref = np.asarray(jax.jit(lambda a, b: jnp.log(a / b))(
        t0.astype(lo.dtype), t1.astype(lo.dtype)))
    np.testing.assert_array_equal(lo, ref)
    if precision == "float64":
        # the case has teeth: torch.log of these ratios is another table
        assert (torch.log(torch.from_numpy(t0 / t1)).numpy() != lo).all()


def test_log_odds_sum_is_ordered():
    """The row sum adds the pair columns left to right (the reference's
    ``lax.scan``), not as a reduction over the axis."""
    rng = np.random.default_rng(8)
    lo = torch.from_numpy(rng.normal(0, 1e3, (6, 6)) * 10.0 ** rng.integers(
        -8, 8, (6, 6)))
    frm = torch.from_numpy(rng.integers(0, 6, (50, 200)))
    to = torch.from_numpy(rng.integers(0, 6, (50, 200)))
    valid = torch.ones((50, 200), dtype=torch.bool)
    got = tm._mmc_pair_log_odds(frm, to, valid, lo).numpy()
    terms = lo.numpy()[frm.numpy(), to.numpy()]
    want = np.zeros(50)
    for t in range(200):
        want = want + terms[:, t]
    np.testing.assert_array_equal(got, want)
    # the case has teeth: a pairwise reduction rounds otherwise
    assert (terms.sum(axis=1) != want).any()


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_padding_invariance_at_every_serving_bucket(glibc_model, precision):
    """Rows padded to every power-of-two bucket up to 64 and lengths to
    the serving length buckets (16, 64, and the power-of-two fallback):
    each score keeps its bits, equal to the reference's."""
    tmp, _, _, rows = glibc_model
    props = {"mm.model.path": str(tmp / "model"),
             "class.label.based.model": "true", "class.labels": "L,C",
             "mmc.score.precision": precision}
    port = tm.MarkovModelClassifier(JobConfig(props), device="cpu")
    ref = jm.MarkovModelClassifier(JaxConfig(props))
    recs = [r.split(",") for r in rows[:9]]
    L = max(len(r) - 1 for r in recs)
    base = port.log_odds_scores(recs)
    assert base == ref.log_odds_scores(recs)
    for b in pow2_buckets(64):
        if b < len(recs):
            continue
        for lb in (16, 64, 128):
            if lb < L:
                continue
            got = port.log_odds_scores(recs, pad_rows_to=b, pad_len_to=lb)
            assert got == base, (b, lb)


# ---------------------------------------------------------------------------
# the streamed trainer and the pair cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("class_based", [True, False])
@pytest.mark.parametrize("chunk,depth", [(64, 2), (64, 0), (1000, 1)])
def test_streamed_trainer_equals_monolithic(chains, class_based, chunk,
                                            depth):
    tmp, _ = chains
    props = dict(TRAIN_PROPS) if class_based else {
        "model.states": ",".join(STATES), "skip.field.count": "2"}
    mono = _both("MarkovStateTransitionModel", props, tmp / "train",
                 tmp / f"mono{class_based}")
    stream = dict(props, **{"pipeline.chunk.rows": str(chunk),
                            "pipeline.prefetch.depth": str(depth)})
    got = _both("MarkovStateTransitionModel", stream, tmp / "train",
                tmp / f"str{class_based}{chunk}_{depth}")
    assert got[0] == got[1] == mono[0] == mono[1]


def test_pair_cache_cold_then_warm(chains, tmp_path):
    """``ingest.cache.enable``: the cold streamed run publishes the pair
    streams (the reference's artifact bytes), the warm run replays them
    off mmap without reading the input, and both write the reference's
    model."""
    tmp, _ = chains
    props = dict(TRAIN_PROPS, **{"pipeline.chunk.rows": "64",
                                 "ingest.cache.enable": "true"})
    out = {}
    for side, job, cfg in (("jax", jm, JaxConfig), ("port", tm, JobConfig)):
        p = dict(props, **{"ingest.cache.dir": str(tmp_path / f"c_{side}")})
        kw = {} if side == "jax" else {"device": "cpu"}
        job.MarkovStateTransitionModel(cfg(p), **kw).run(
            str(tmp / "train"), str(tmp_path / f"cold_{side}"))
        out[side] = p
    (art,) = [d for d in os.listdir(tmp_path / "c_port")
              if d.startswith("mkv-")]
    assert os.listdir(tmp_path / "c_jax") == [art]
    for name in ("frm.bin", "to.bin", "cls.bin", "meta.json"):
        with open(tmp_path / "c_port" / art / name, "rb") as a, \
                open(tmp_path / "c_jax" / art / name, "rb") as b:
            assert a.read() == b.read(), name
    loads = []
    real = ingestcache.PairStreamCache.load

    def spy(self, chunk_rows):
        got = real(self, chunk_rows)
        loads.append(got is not None)
        return got

    ingestcache.PairStreamCache.load = spy
    try:
        tm.MarkovStateTransitionModel(JobConfig(out["port"]),
                                      device="cpu").run(
            str(tmp / "train"), str(tmp_path / "warm_port"))
    finally:
        ingestcache.PairStreamCache.load = real
    assert loads == [True]
    assert _read(tmp_path / "warm_port") == _read(tmp_path / "cold_jax") \
        == _read(tmp_path / "cold_port")


def test_streamed_trainer_falls_back_on_late_class_label(tmp_path):
    """A class label first seen past the first chunk's cap re-runs the
    monolithic path: the same model as the reference."""
    rows = [f"E{i},A,LL,HH,LL" for i in range(10)] + \
        [f"F{i},{c},HH,LL,HL" for i, c in enumerate("BCDEFG")]
    write_output(str(tmp_path / "in"), rows)
    props = {"model.states": "LL,LH,HL,HH", "class.label.field.ord": "1",
             "skip.field.count": "1", "pipeline.chunk.rows": "4"}
    want, got, _, _ = _both("MarkovStateTransitionModel", props,
                            tmp_path / "in", tmp_path / "m")
    assert got == want
    assert got.decode().count("classLabel:") == 7


def test_streamed_trainer_refuses_a_mesh(chains):
    tmp, _ = chains
    job = tm.MarkovStateTransitionModel(JobConfig(dict(
        TRAIN_PROPS, **{"pipeline.chunk.rows": "64"})), device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        job.run(str(tmp / "train"), str(tmp / "nomesh"),
                mesh=pmesh.make_mesh([CPU] * 2))


# ---------------------------------------------------------------------------
# the runbooks through both command lines
# ---------------------------------------------------------------------------

def _markov_runbooks(work, main, dg, extra=()):
    """resource/churn_markov/run.sh and resource/hmm_viterbi/run.sh with
    the working directory at the runbooks' layout.  The Projection leg's
    event rows are shuffled by a seeded permutation instead of ``sort
    -R``: the job orders them again, so its output does not depend on the
    shuffle."""
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)

    def job(*argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(list(argv) + list(extra))
        assert rc in (0, None), err.getvalue()

    try:
        assert dg(["churn_state_seqs", "800", "--seed", "31",
                   "--out", "work/all.csv"]) == 0
        with open("work/all.csv") as fh:
            rows = fh.read().splitlines()
        events = [f"{f[0]},{f[1]},{i - 2},{f[i]}"
                  for f in (r.split(",") for r in rows)
                  for i in range(2, len(f))]
        perm = np.random.default_rng(2024).permutation(len(events))
        write_output("work/events", [events[i] for i in perm])
        job("Projection", f"-Dconf.path={CHURN}/projection.properties",
            "work/events", "work/seqs")
        with open("work/seqs/part-r-00000") as fh:
            assert sorted(fh.read().splitlines()) == sorted(rows)
        write_output("work/train", rows[:600])
        write_output("work/test", rows[-200:])
        job("MarkovStateTransitionModel",
            f"-Dconf.path={CHURN}/mst.properties", "work/train", "work/model")
        job("MarkovModelClassifier", f"-Dconf.path={CHURN}/mmc.properties",
            "work/test", "work/pred")
        assert dg(["hmm_seqs", "300", "--seed", "23",
                   "--out", "work/htrain/part-00000"]) == 0
        assert dg(["hmm_obs", "40", "--seed", "67",
                   "--out", "work/obs/part-00000"]) == 0
        job("HiddenMarkovModelBuilder", f"-Dconf.path={HMM}/hmm.properties",
            "work/htrain", "work/hmm")
        job("ViterbiStatePredictor", f"-Dconf.path={HMM}/vit.properties",
            "-Dhmm.model.path=work/hmm", "work/obs", "work/dec")
    finally:
        os.chdir(cwd)


RUNBOOK_OUTPUTS = ["seqs", "model", "pred", "hmm", "dec"]


@pytest.fixture(scope="module")
def markov_runbooks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("markov_runbooks")
    _markov_runbooks(str(tmp / "jax"), jax_main, jax_datagen)
    _markov_runbooks(str(tmp / "port"), port_main, datagen.main,
                     extra=("--device", "cpu"))
    return tmp


@pytest.mark.parametrize("name", RUNBOOK_OUTPUTS)
def test_markov_runbooks_byte_identical(markov_runbooks, name):
    got = _read(markov_runbooks / "port" / "work" / name)
    assert got == _read(markov_runbooks / "jax" / "work" / name)
    assert got


def test_marketing_helpers_match_reference(chains):
    tmp, _ = chains
    rows = [["c1", "x1", "2013-01-01", "40"], ["c1", "x2", "2013-01-15", "50"],
            ["c1", "x3", "2013-03-20", "30"], ["c2", "x1", "2013-01-05", "70"],
            ["c2", "x2", "2013-02-25", "90"], ["c3", "x1", "2013-01-05", "10"]]
    assert tm.xactions_to_state_seqs(rows) == jm.xactions_to_state_seqs(rows)
    proj = [["c1", "2013-01-01", "40", "2013-01-15", "50", "2013-03-20", "30"]]
    assert tm.projected_to_state_seqs(proj) == jm.projected_to_state_seqs(proj)
    lines = [",".join(tm.MARKETING_STATES)] + [
        ",".join(str(100 + 7 * i + j) for j in range(9)) for i in range(9)]
    model_p, model_j = tm.MarkovModel(lines, False), jm.MarkovModel(lines,
                                                                     False)
    assert tm.marketing_next_dates(rows, model_p) == \
        jm.marketing_next_dates(rows, model_j)


def test_markov_jobs_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for job in ("MarkovStateTransitionModel", "MarkovModelClassifier",
                "HiddenMarkovModelBuilder", "ViterbiStatePredictor"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tm, job)(JobConfig({}))
