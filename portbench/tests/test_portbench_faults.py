"""A run with the measured path broken underneath comes out not correct:
each fault the cell can have, planted in the program on the CPU, past
the harness's look for a card.  (One card a cell: no exchange between
cards to leave out.  A serving cell has no state a step carries.)"""

import itertools

import pytest
import torch

from _tiny import run_tiny


def _nb_unchanged(orig):
    def local(x, y, mask, n_class, max_bins, out=None):
        if out is not None:
            return out                      # the carry comes back unchanged
        return torch.zeros((n_class, x.shape[1], max_bins), dtype=torch.int32,
                           device=x.device)
    return local


def _nb_half(orig):
    def local(x, y, mask, n_class, max_bins, out=None):
        h = x.shape[0] // 2
        return orig(x[:h], y[:h], None if mask is None else mask[:h],
                    n_class, max_bins, out=out)
    return local


def _mk_unchanged(orig):
    def local(frm, to, cls, mask, n_class, n_states):
        return torch.zeros_like(orig(frm, to, cls, mask, n_class, n_states))
    return local


def _mk_half(orig):
    def local(frm, to, cls, mask, n_class, n_states):
        h = frm.shape[0] // 2
        return orig(frm[:h], to[:h], cls[:h],
                    None if mask is None else mask[:h], n_class, n_states)
    return local


def _altered_output(orig):
    """One model line's last number changed where the job writes it."""
    def write(out_path, lines, *a, **kw):
        lines = list(lines)
        k = len(lines) // 2
        head, _, n = lines[k].rpartition(",")
        lines[k] = f"{head},{int(n) + 1}"
        return orig(out_path, lines, *a, **kw)
    return write


TRAIN = {
    "churn_nb.train": ("avenir_tpu_torch.models.bayesian",
                       {"state unchanged": ("_nb_local", _nb_unchanged),
                        "half the batch": ("_nb_local", _nb_half),
                        "answer altered": ("write_output", _altered_output)}),
    "churn_markov.train": ("avenir_tpu_torch.models.markov",
                           {"state unchanged": ("_markov_local", _mk_unchanged),
                            "half the batch": ("_markov_local", _mk_half),
                            "answer altered": ("write_output",
                                               _altered_output)}),
}


@pytest.mark.parametrize("name,fault", [(n, f) for n, (_, fs) in TRAIN.items()
                                        for f in fs])
def test_train_fault_is_caught(name, fault, tmp_env, monkeypatch):
    import importlib
    mod = importlib.import_module(TRAIN[name][0])
    attr, make = TRAIN[name][1][fault]
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = run_tiny(name)
    assert not res["correct"], res["checks"]


def _serve_half(orig):
    """Every second row the scorer is given goes unscored: it gets the
    answer of the row before it."""
    turn = itertools.count()
    last = {}

    def predict(self, lines):
        out = orig(self, lines)
        for i, v in enumerate(out):
            if next(turn) % 2 and "prev" in last:
                out[i] = last["prev"]
            last["prev"] = v
        return out
    return predict


def _serve_altered(orig):
    """One answer in four has its last digit changed where it is made."""
    turn = itertools.count()

    def predict(self, lines):
        out = orig(self, lines)
        for i, v in enumerate(out):
            if v is not None and next(turn) % 4 == 0:
                out[i] = v[:-1] + ("1" if v[-1] != "1" else "2")
        return out
    return predict


def _serve_errors(orig):
    """One row in eight goes unscored, which the server answers with an
    error."""
    turn = itertools.count()

    def predict(self, lines):
        out = orig(self, lines)
        return [None if next(turn) % 8 == 0 else v for v in out]
    return predict


SERVE = {"churn_nb.serve": "NaiveBayesAdapter",
         "churn_markov.serve": "MarkovClassifierAdapter"}


@pytest.mark.parametrize("name", sorted(SERVE))
@pytest.mark.parametrize("fault", [_serve_half, _serve_altered,
                                   _serve_errors])
def test_serve_fault_is_caught(name, fault, tmp_env, monkeypatch):
    from avenir_tpu_torch.serve import engine
    cls = getattr(engine, SERVE[name])
    monkeypatch.setattr(cls, "predict_lines", fault(cls.predict_lines))
    res = run_tiny(name)
    assert not res["correct"], res["checks"]
