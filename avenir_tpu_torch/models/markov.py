"""Markov-chain models: transition trainer, classifier, HMM builder, Viterbi.

The port's counterpart of ``avenir_tpu/models/markov.py``, with the same
config keys, input layouts and output bytes:

- ``MarkovStateTransitionModel`` (prefix ``mst``) counts (class?, from,
  to) state transitions over each row's trailing state sequence,
  row-normalizes to scaled ints with whole-row Laplace correction and
  writes one row per line after an optional state-list header.  The
  counts are one ``count_table`` over every adjacent pair, on the job's
  device or summed over a mesh (``ops.counting.sharded_reduce``); with
  ``pipeline.chunk.rows`` the pairs stream through
  ``core.pipeline.streaming_fold`` (and through the pair cache of
  ``core.ingestcache`` when ``ingest.cache.enable`` is on).
- ``MarkovModelClassifier`` sums ``log(P_c0[from, to] / P_c1[from, to])``
  over each sequence and thresholds it.  The reference takes the log of
  the model's own tables on the device, so its bits are XLA's: glibc's
  ``log`` in float64 (``math.log``), and XLA's float32 ``log``
  (``ops.xla_math.log_f32``) under ``mmc.score.precision=float32``.
  ``torch.log`` is correctly rounded in neither case on either device, so
  the port computes the S x S log-ratio table once, on the host, when the
  model loads, and moves it to the device: a score is then a gather and
  an ordered left-to-right sum over the sequence (``+0.0`` at padding),
  both exact copies of the reference's arithmetic, so serving buckets
  cannot change a score.
- ``HiddenMarkovModelBuilder`` counts the STATE_TRANS / STATE_OBS /
  INITIAL_STATE families from fully tagged ``obs:state`` rows (device
  counts) or partially tagged rows with a distance-decay window (host);
  the initial vector keeps the reference's scale of 100.
- ``ViterbiStatePredictor`` decodes the observation rows in one batch:
  ``viterbi_batch`` runs the max-product recursion in log space on the
  device over ``[n, S, S]`` candidates a step, with the log tables taken
  on the host (``math.log``), the first maximum winning ties (as
  ``jnp.argmax`` and the reference's strict ``>``), then the backtrack.

Every job takes a ``device`` (``cuda:0`` unless the caller asks for the
CPU).  The trainer's ``fold_spec`` exports its part of a shared scan
(core.multiscan, ``_MarkovFoldSpec``).  Not ported yet: ``mesh=`` on the
streamed trainer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.multiscan import FoldSpec as MultiScanFoldSpec
from ..core.obs import get_tracer, traced_run
from ..core.tabular import deserialize_matrix, normalize_rows, serialize_matrix
from ..device import resolve_device
from ..ops.counting import count_table, sharded_reduce


# ---------------------------------------------------------------------------
# sequence ingest
# ---------------------------------------------------------------------------

def encode_sequences(records: Sequence[Sequence[str]], skip: int,
                     vocab: Dict[str, int],
                     strict: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Encode each record's trailing items as vocab ids, padded with -1.

    Returns (seq int32 [n, Lmax], lengths int32 [n]).  Unknown symbols raise
    (strict) or map to -1.
    """
    n = len(records)
    lengths = np.asarray([max(0, len(r) - skip) for r in records], dtype=np.int32)
    lmax = int(lengths.max()) if n else 0
    seq = np.full((n, lmax), -1, dtype=np.int32)
    for i, r in enumerate(records):
        for t, sym in enumerate(r[skip:]):
            if strict and sym not in vocab:
                raise KeyError(f"unknown state/observation symbol: {sym!r}")
            seq[i, t] = vocab.get(sym, -1)
    return seq, lengths


def _transition_pairs(seq: np.ndarray):
    """(from, to) index arrays for every adjacent pair; -1-padded cells
    self-mask in count_table."""
    return seq[:, :-1], seq[:, 1:]


# The count functions: ``local_fn(*arrays, mask, *static_args)`` of
# ``ops.counting.sharded_reduce`` and ``core.pipeline.streaming_fold``.
def _markov_local(frm, to, cls, mask, n_class, n_states):
    m = None if mask is None else mask[:, None]
    if n_class > 0:
        return count_table((n_class, n_states, n_states),
                           (cls[:, None], frm, to), mask=m)
    return count_table((n_states, n_states), (frm, to), mask=m)


def _markov_pair_local(frm, to, cls, mask, n_class, n_states, out=None):
    """Streaming-fold form of ``_markov_local`` over FLATTENED 1-D
    transition-pair streams; -1 padding cells drop by the count_table
    range rule.  With ``out`` the chunk's counts are added into it."""
    if n_class > 0:
        counts = count_table((n_class, n_states, n_states), (cls, frm, to),
                             mask=mask)
    else:
        counts = count_table((n_states, n_states), (frm, to), mask=mask)
    if out is None:
        return counts
    out += counts
    return out


def _hmm_local(frm, to, obs_s, obs_o, init_s, mask, S, O):
    m = None if mask is None else mask[:, None]
    return {
        "trans": count_table((S, S), (frm, to), mask=m),
        "obs": count_table((S, O), (obs_s, obs_o), mask=m),
        "init": count_table((S,), (init_s,), mask=mask),
    }


def _count(local_fn, *arrays, device, mesh, static_args):
    """``local_fn`` over host row arrays on ``device``, or summed over
    ``mesh`` when one is given; the tables come back to the host."""
    if mesh is not None:
        res = sharded_reduce(local_fn, *arrays, mesh=mesh,
                             static_args=static_args)
    else:
        res = sharded_reduce(local_fn, *arrays, device=device,
                             static_args=static_args)
    if isinstance(res, dict):
        return {k: v.cpu().numpy().astype(np.int64) for k, v in res.items()}
    return res.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# host log tables
# ---------------------------------------------------------------------------

def _glibc_log(x: float) -> float:
    """``math.log`` (glibc's correctly rounded double ``log``, which XLA's
    float64 ``log`` on the CPU equals) with the IEEE special cases."""
    if x > 0.0:
        return math.log(x) if x != math.inf else math.inf
    if x == 0.0:
        return -math.inf
    return math.nan


def host_log(table: np.ndarray) -> np.ndarray:
    """Elementwise float64 ``log`` of a small host table, bit for bit the
    reference's ``jnp.log`` (``torch.log`` and numpy's vectorized ``log``
    are not correctly rounded)."""
    t = np.asarray(table, dtype=np.float64)
    return np.asarray([_glibc_log(float(v)) for v in t.ravel()],
                      dtype=np.float64).reshape(t.shape)


def log_ratio_table(t0: np.ndarray, t1: np.ndarray,
                    precision: str) -> np.ndarray:
    """The classifier's ``log(t0 / t1)`` per (from, to) cell, in the
    asked precision, as the reference computes it on the device: the
    ratio in that precision, then XLA's ``log`` (glibc's in float64, the
    emulated XLA float32 ``log`` in float32)."""
    dt = np.float64 if precision == "float64" else np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.asarray(t0, dt) / np.asarray(t1, dt)
    if precision == "float64":
        return host_log(ratio)
    from ..ops.xla_math import log_f32
    return log_f32(torch.from_numpy(ratio)).numpy()


# ---------------------------------------------------------------------------
# Markov transition model trainer
# ---------------------------------------------------------------------------

class MarkovStateTransitionModel:
    """Trainer job; config prefix ``mst`` with un-prefixed fallback."""

    # rough pair-stream bytes per input row for device-budget chunk sizing
    # (3 int32 streams x ~8 transitions)
    _BUDGET_ROW_BYTES = 96

    def __init__(self, config: JobConfig, device=None):
        self.config = config.with_prefix("mst") if not config.prefix else config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        states = cfg.must("model.states").split(",")
        vocab = {s: i for i, s in enumerate(states)}
        S = len(states)
        skip = cfg.get_int("skip.field.count", 0)
        class_ord = cfg.get_int("class.label.field.ord", -1)
        scale = cfg.get_int("trans.prob.scale", 1000)
        output_states = cfg.get_boolean("output.states", True)
        # the class label occupies one leading field when present
        eff_skip = skip + (1 if class_ord >= 0 else 0)

        tracer = get_tracer()
        chunk_rows = cfg.pipeline_chunk_rows(row_bytes=self._BUDGET_ROW_BYTES)
        counted = None
        if chunk_rows is not None:
            with tracer.span("phase:train"):
                counted = self._count_streamed(
                    in_path, delim_regex, vocab, S, eff_skip, class_ord,
                    chunk_rows, cfg.pipeline_prefetch_depth(), mesh)
        if counted is not None:
            counts, class_labels = counted
        else:
            with tracer.span("phase:train"):
                records = [split_line(l, delim_regex)
                           for l in read_lines(in_path)]
                # rows too short to hold a transition are skipped
                records = [r for r in records if len(r) >= eff_skip + 2]
                class_labels = []
                cls_idx = np.zeros(len(records), dtype=np.int32)
                if class_ord >= 0:
                    seen: Dict[str, int] = {}
                    for i, r in enumerate(records):
                        lbl = r[class_ord]
                        if lbl not in seen:
                            seen[lbl] = len(seen)
                            class_labels.append(lbl)
                        cls_idx[i] = seen[lbl]
                seq, _ = encode_sequences(records, eff_skip, vocab)
                if seq.shape[1] < 2:
                    counts = (np.zeros((len(class_labels), S, S),
                                       dtype=np.int64)
                              if class_ord >= 0
                              else np.zeros((S, S), dtype=np.int64))
                else:
                    frm, to = _transition_pairs(seq)
                    counts = _count(
                        _markov_local, frm, to, cls_idx, device=self.device,
                        mesh=mesh, static_args=(len(class_labels)
                                                if class_ord >= 0 else 0, S))

        with tracer.span("phase:emit"):
            write_output(out_path, self._model_lines(
                counts, class_labels, states, scale, output_states,
                class_ord))
        counters.set("Markov", "Transitions", int(counts.sum()))
        return counters

    @staticmethod
    def _model_lines(counts, class_labels, states, scale, output_states,
                     class_ord) -> List[str]:
        """Reference-format model lines (the monolithic and the streamed
        counts alike)."""
        lines: List[str] = []
        if output_states:
            lines.append(",".join(states))
        if class_ord >= 0:
            for ci, lbl in enumerate(class_labels):
                lines.append(f"classLabel:{lbl}")
                lines.extend(
                    serialize_matrix(normalize_rows(counts[ci], scale)))
        else:
            lines.extend(serialize_matrix(normalize_rows(counts, scale)))
        return lines

    def _stream_device(self, mesh) -> torch.device:
        if mesh is None:
            return self.device
        if mesh.size != 1:
            raise NotImplementedError(
                "the streamed Markov trainer (pipeline.chunk.rows) runs on "
                "one device; a mesh of several positions is not ported yet")
        return mesh.devices.flat[0]

    def _count_streamed(self, in_path, delim_regex, vocab, S, eff_skip,
                        class_ord, chunk_rows, depth, mesh):
        """One streaming pass over row chunks: per chunk the trailing
        state sequences encode and flatten to 1-D (from, to, class) pair
        streams, folded through ``core.pipeline``.  Class labels are
        discovered in input order like the monolithic path; the class
        extent is capped after the first chunk, and a label first seen
        beyond the cap returns None, so the caller re-runs the monolithic
        path for identical output."""
        from ..core import ingestcache, pipeline
        from ..core.binning import ChunkedEncodeUnsupported

        device = self._stream_device(mesh)
        # parse-once cache: the flattened pair streams are this job's whole
        # parse product, so a validated artifact replays them off mmap
        # chunk for chunk with the recorded class labels; counts truncate
        # to n_class either way, so warm output equals cold output
        pcache = ingestcache.PairStreamCache.from_config(
            self.config, in_path, list(vocab), eff_skip, class_ord,
            delim_regex)
        cached = pcache.load(chunk_rows) if pcache is not None else None
        if cached is not None:
            class_labels = list(cached.class_labels)
            n_class_cap = (max(len(class_labels), 1) + 2
                           if class_ord >= 0 else 0)
            counts = pipeline.streaming_fold(
                (tuple(np.asarray(a) for a in ch)
                 for ch in cached.chunks()),
                _markov_pair_local, static_args=(n_class_cap, S),
                device=device, prefetch_depth=depth)
            return self._streamed_result(counts, class_labels, class_ord, S)
        builder = pcache.builder(chunk_rows) if pcache is not None else None

        class_labels: List[str] = []
        seen: Dict[str, int] = {}
        cap = [None]          # set after the first chunk is parsed

        def parsed():
            for lines in pipeline.iter_line_chunks(in_path, chunk_rows):
                records = [split_line(l, delim_regex) for l in lines]
                records = [r for r in records if len(r) >= eff_skip + 2]
                if not records:
                    continue
                cls_idx = np.zeros(len(records), dtype=np.int32)
                if class_ord >= 0:
                    for i, r in enumerate(records):
                        lbl = r[class_ord]
                        if lbl not in seen:
                            seen[lbl] = len(seen)
                            class_labels.append(lbl)
                        cls_idx[i] = seen[lbl]
                    if cap[0] is not None and len(class_labels) > cap[0]:
                        raise ChunkedEncodeUnsupported("late class label")
                seq, _ = encode_sequences(records, eff_skip, vocab)
                if seq.shape[1] < 2:
                    continue
                frm, to = _transition_pairs(seq)
                cls = np.repeat(cls_idx, frm.shape[1])
                out = (frm.ravel(), to.ravel(), cls)
                if builder is not None:
                    builder.add(*out)
                yield out

        try:
            first, stream = pipeline.peek(parsed())
            n_class_cap = 0
            if class_ord >= 0:
                # headroom covers stragglers; a label first seen beyond it
                # falls back
                cap[0] = n_class_cap = max(len(class_labels), 1) + 2
            counts = pipeline.streaming_fold(
                stream, _markov_pair_local, static_args=(n_class_cap, S),
                device=device, prefetch_depth=depth)
        except ChunkedEncodeUnsupported:
            if builder is not None:
                builder.abort()
            return None
        if builder is not None:
            builder.finish(class_labels)
        return self._streamed_result(counts, class_labels, class_ord, S)

    def fold_spec(self, out_path: str):
        """This trainer's shared-scan ``core.multiscan.FoldSpec``."""
        return _MarkovFoldSpec(self, out_path)

    @staticmethod
    def _streamed_result(counts, class_labels, class_ord, S):
        n_class = len(class_labels)
        if counts is None:
            counts = (np.zeros((n_class, S, S), dtype=np.int64)
                      if class_ord >= 0 else np.zeros((S, S), np.int64))
        elif class_ord >= 0:
            counts = counts[:n_class]
        return np.asarray(counts, dtype=np.int64), class_labels


class _MarkovFoldSpec(MultiScanFoldSpec):
    """The Markov trainer's part of the shared scan: each chunk's trailing
    state sequences flatten to 1-D (from, to, class) pair streams folded
    by ``_markov_pair_local``; class labels are discovered in input order
    as on the standalone paths, with the same class cap after the first
    chunk and the same withdrawal past it.  The fold certificate
    (core.algebra) holds its split invariance."""

    # the reference pads these variable-length streams to power-of-two
    # extents; the port's engine does not pad and ignores the flag
    fixed_capacity = False

    def __init__(self, job: "MarkovStateTransitionModel", out_path: str):
        cfg = job.config
        self.job = job
        self.out_path = out_path
        self.name = type(job).__name__
        self.local_fn = _markov_pair_local
        self.static_args: tuple = ()
        self.states = cfg.must("model.states").split(",")
        self.vocab = {s: i for i, s in enumerate(self.states)}
        self.S = len(self.states)
        skip = cfg.get_int("skip.field.count", 0)
        self.class_ord = cfg.get_int("class.label.field.ord", -1)
        self.eff_skip = skip + (1 if self.class_ord >= 0 else 0)
        self.scale = cfg.get_int("trans.prob.scale", 1000)
        self.output_states = cfg.get_boolean("output.states", True)
        self.class_labels: List[str] = []
        self._seen: Dict[str, int] = {}
        self._cap: Optional[int] = None

    def encode(self, ctx):
        from ..core.binning import ChunkedEncodeUnsupported

        records = [r for r in ctx.fields() if len(r) >= self.eff_skip + 2]
        if not records:
            return None
        cls_idx = np.zeros(len(records), dtype=np.int32)
        if self.class_ord >= 0:
            for i, r in enumerate(records):
                lbl = str(r[self.class_ord])
                if lbl not in self._seen:
                    self._seen[lbl] = len(self._seen)
                    self.class_labels.append(lbl)
                cls_idx[i] = self._seen[lbl]
            if self._cap is not None and len(self.class_labels) > self._cap:
                raise ChunkedEncodeUnsupported("late class label")
        seq, _ = encode_sequences(records, self.eff_skip, self.vocab)
        if seq.shape[1] < 2:
            return None
        if self._cap is None:
            # headroom covers stragglers; a label first seen beyond it
            # withdraws the spec (the standalone re-run)
            n_class_cap = 0
            if self.class_ord >= 0:
                self._cap = n_class_cap = max(len(self.class_labels), 1) + 2
            self.static_args = (n_class_cap, self.S)
        frm, to = _transition_pairs(seq)
        cls = np.repeat(cls_idx, frm.shape[1])
        return frm.ravel(), to.ravel(), cls

    def finalize(self, carry) -> Counters:
        counters = Counters()
        counts = np.asarray(carry)
        if self.class_ord >= 0:
            counts = counts[:len(self.class_labels)]
        write_output(self.out_path, self.job._model_lines(
            counts, self.class_labels, self.states, self.scale,
            self.output_states, self.class_ord))
        counters.set("Markov", "Transitions", int(counts.sum()))
        return counters


# ---------------------------------------------------------------------------
# model + classifier
# ---------------------------------------------------------------------------

class MarkovModel:
    """Text-format model loader (markov/MarkovModel.java:38-65)."""

    def __init__(self, lines: List[str], class_label_based: bool):
        self.states = lines[0].split(",")
        S = len(self.states)
        self.index = {s: i for i, s in enumerate(self.states)}
        self.class_trans: Dict[str, np.ndarray] = {}
        self.trans: Optional[np.ndarray] = None
        i = 1
        if class_label_based:
            while i < len(lines):
                if lines[i].startswith("classLabel"):
                    label = lines[i].split(":")[1]
                    i += 1
                    self.class_trans[label] = deserialize_matrix(lines[i:i + S], S)
                    i += S
                else:  # pragma: no cover - malformed files mirror Java behavior
                    raise ValueError(f"unexpected model line: {lines[i]}")
        else:
            self.trans = deserialize_matrix(lines[1:1 + S], S)

    @classmethod
    def load(cls, path: str, class_label_based: bool) -> "MarkovModel":
        return cls(list(read_lines(path)), class_label_based)


# ---------------------------------------------------------------------------
# transaction -> state conversion + marketing plan (L0 resource scripts)
# ---------------------------------------------------------------------------

MARKETING_STATES = ["SL", "SE", "SG", "ML", "ME", "MG", "LL", "LE", "LG"]


def _pair_state(pr_date, pr_amt: int, date, amt: int) -> str:
    """One (prev, cur) transaction pair -> 2-letter state: days-gap letter
    S/M/L x amount-trend letter L/E/G (resource/xaction_state.rb:24-39)."""
    days = (date - pr_date).days
    dd = "S" if days < 30 else ("M" if days < 60 else "L")
    ad = "L" if pr_amt < 0.9 * amt else ("E" if pr_amt < 1.1 * amt else "G")
    return dd + ad


def _group_xactions(rows):
    """Group custID,xid,date,amount rows into per-customer (date, amount)
    histories preserving input order (resource/xaction_seq.rb:9-19)."""
    import datetime

    hist: Dict[str, list] = {}
    for items in rows:
        hist.setdefault(items[0], []).append(
            (datetime.date.fromisoformat(items[2]), int(items[3])))
    return hist


def xactions_to_state_seqs(rows) -> List[List[str]]:
    """resource/xaction_seq.rb equivalent: raw transactions -> one
    ``custID,state,state,...`` row per customer with >= 2 transactions —
    the Markov trainer's input format."""
    out = []
    for cid, hist in _group_xactions(rows).items():
        seq = [_pair_state(*hist[i - 1], *hist[i])
               for i in range(1, len(hist))]
        if seq:
            out.append([cid] + seq)
    return out


def projected_to_histories(rows) -> Dict[str, list]:
    """Parse compact chombo-Projection output rows
    ``custID,date1,amt1,date2,amt2,...`` (projection.field=2,3 +
    format.compact=true per resource/buyhist.properties:6-11, already
    time-ordered by the projection) into per-customer (date, amount)
    histories — the same shape ``_group_xactions`` builds from raw rows."""
    import datetime

    return {items[0]: [(datetime.date.fromisoformat(items[i]),
                        int(items[i + 1]))
                       for i in range(1, len(items) - 1, 2)]
            for items in rows}


def projected_to_state_seqs(rows) -> List[List[str]]:
    """resource/xaction_seq.rb equivalent for the chombo Projection leg
    (cust_churn_markov_chain tutorial:26-45): compact projected rows ->
    one ``custID,state,state,...`` row per customer with >= 2
    transactions."""
    out = []
    for cid, hist in projected_to_histories(rows).items():
        seq = [_pair_state(*hist[i - 1], *hist[i])
               for i in range(1, len(hist))]
        if seq:
            out.append([cid] + seq)
    return out


def marketing_next_dates(rows, model: "MarkovModel") -> List[str]:
    """resource/mark_plan.rb:39-92 equivalent over raw transaction rows."""
    return marketing_next_dates_from_histories(_group_xactions(rows), model)


def marketing_next_dates_from_histories(histories: Dict[str, list],
                                        model: "MarkovModel") -> List[str]:
    """resource/mark_plan.rb:39-92 equivalent: per customer, map the last
    observed transaction state through the trained (non-class) transition
    matrix, take the most likely next state, and schedule the next
    marketing contact 15/45/90 days after the last transaction depending on
    the predicted gap letter.  Emits ``custID,ISO-date`` lines.  Histories
    are per-customer time-ordered (date, amount) lists — from
    ``_group_xactions`` (raw rows) or ``projected_to_histories``
    (Projection-job output)."""
    import datetime

    trans = model.trans
    assert trans is not None, "marketing plan needs a non-class-based model"
    out = []
    for cid, hist in histories.items():
        if len(hist) < 2:
            continue
        last_state = _pair_state(*hist[-2], *hist[-1])
        row = trans[model.index[last_state]]
        next_state = model.states[int(np.argmax(row))]
        gap = {"S": 15, "M": 45}.get(next_state[0], 90)
        next_date = hist[-1][0] + datetime.timedelta(days=gap)
        out.append(f"{cid},{next_date.isoformat()}")
    return out


def _mmc_pair_log_odds(frm: torch.Tensor, to: torch.Tensor,
                       valid: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Per-row log-odds ``sum log(P_c0[from, to] / P_c1[from, to])`` over
    a sequence batch: a gather from the ``[S, S]`` log-ratio table ``lo``
    (invalid, -1-padded cells give exact 0) and an ORDERED left-to-right
    sum over the pair axis, one column after another, as the reference's
    ``lax.scan`` adds them.  A reduction over the axis would associate
    differently with the padded extent; the ordered sum cannot be moved
    by padding (each padded term adds +0.0), which is what lets serving
    pad rows and lengths to buckets and still answer the batch job's
    bytes.  Shared by the batch classifier and the serving adapter."""
    S = lo.shape[0]
    cell = torch.where(valid, frm.to(torch.int64) * S + to, 0)
    g = torch.where(valid, lo.reshape(-1)[cell],
                    torch.zeros((), dtype=lo.dtype, device=lo.device))
    acc = torch.zeros(g.shape[0], dtype=lo.dtype, device=lo.device)
    for t in range(g.shape[1]):
        acc = acc + g[:, t]
    return acc


class MarkovModelClassifier:
    """Map-only log-odds classifier, vectorized over the sequence batch.

    The scoring core is :meth:`classify_records`, which the serving
    adapter (``serve.engine.MarkovClassifierAdapter``) runs too: the
    scorer is the module-level ``_mmc_pair_log_odds`` over the log-ratio
    table on the device, and its ordered row sum makes scores invariant
    to the serving buckets' padding."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._prepared = False

    def _prepare(self) -> None:
        """Parse the config and load the model once (idempotent); the
        serving registry builds the classifier at model-load time and
        calls ``classify_records`` per micro-batch."""
        if self._prepared:
            return
        cfg = self.config
        self.skip = cfg.get_int("skip.field.count", 1)
        self.id_ord = cfg.get_int("id.field.ord", 0)
        class_based = cfg.get_boolean("class.label.based.model", False)
        self.validation = cfg.get_boolean("validation.mode", False)
        self.class_ord = -1
        if self.validation:
            self.skip += 1
            self.class_ord = cfg.get_int("class.label.field.ord", -1)
            if self.class_ord < 0:
                raise ValueError(
                    "In validation mode actual class labels must be provided")
        self.model = MarkovModel.load(cfg.must("mm.model.path"), class_based)
        self.class_labels = cfg.must("class.labels").split(",")
        self.threshold = cfg.get_float("log.odds.threshold", 0.0)
        # mmc.score.precision=float32 takes the tables (and so the whole
        # log-odds sum) to float32: the serving variant ``f32``.  A batch
        # run with the same key gives the variant's online bytes.
        self.score_precision = cfg.get("mmc.score.precision", "float64")
        if self.score_precision not in ("float64", "float32"):
            raise ValueError(
                f"invalid mmc.score.precision: {self.score_precision}")
        lo = log_ratio_table(self.model.class_trans[self.class_labels[0]],
                             self.model.class_trans[self.class_labels[1]],
                             self.score_precision)
        self._lo = torch.from_numpy(lo).to(self.device)
        self._prepared = True

    def tables(self) -> Tuple[torch.Tensor, ...]:
        """The device-resident model state (the log-ratio table)."""
        self._prepare()
        return (self._lo,)

    def min_fields(self) -> int:
        """Shortest record the classifier can score (shorter rows are
        dropped by the batch job and refused per row by serving)."""
        self._prepare()
        return self.skip + 2

    def log_odds_scores(self, usable: List[List[str]], score_fn=None,
                        pad_rows_to: Optional[int] = None,
                        pad_len_to: Optional[int] = None) -> List[float]:
        """Log-odds per usable record.  ``pad_rows_to``/``pad_len_to`` pad
        the encoded ``[n, Lmax]`` sequence matrix with -1 up to a serving
        bucket, so the scorer sees a fixed set of shapes; padding adds
        exact ``+0.0`` at the end of the ordered sum, so it cannot move a
        score."""
        self._prepare()
        if not usable:
            return []
        seq, _ = encode_sequences(usable, self.skip, self.model.index)
        n, L = seq.shape
        if pad_len_to is not None and pad_len_to > L:
            seq = np.concatenate(
                [seq, np.full((n, pad_len_to - L), -1, np.int32)], axis=1)
        if pad_rows_to is not None and pad_rows_to > n:
            seq = np.concatenate(
                [seq, np.full((pad_rows_to - n, seq.shape[1]), -1, np.int32)],
                axis=0)
        frm, to = _transition_pairs(seq)
        valid = (frm >= 0) & (to >= 0)
        fn = score_fn if score_fn is not None else _mmc_pair_log_odds
        dev = self.device
        total = fn(torch.from_numpy(np.ascontiguousarray(frm)).to(dev),
                   torch.from_numpy(np.ascontiguousarray(to)).to(dev),
                   torch.from_numpy(valid).to(dev), self._lo)
        return total.cpu().numpy()[:n].tolist()

    def classify_records(self, records: List[List[str]], counters: Counters,
                         score_fn=None, pad_rows_to: Optional[int] = None,
                         pad_len_to: Optional[int] = None) -> List[str]:
        """Classify pre-split records; returns output lines (records too
        short to hold a transition are dropped, as the reference mapper
        does)."""
        self._prepare()
        delim = self.config.field_delim_out()
        usable = [r for r in records if len(r) >= self.skip + 2]
        log_odds = self.log_odds_scores(usable, score_fn=score_fn,
                                        pad_rows_to=pad_rows_to,
                                        pad_len_to=pad_len_to)
        out: List[str] = []
        for i, r in enumerate(usable):
            pred = (self.class_labels[0] if log_odds[i] > self.threshold
                    else self.class_labels[1])
            parts = [r[self.id_ord]]
            if self.validation:
                parts.append(r[self.class_ord])
                if r[self.class_ord] == pred:
                    counters.incr("Validation", "Correct")
                else:
                    counters.incr("Validation", "Incorrect")
            parts += [pred, repr(float(log_odds[i]))]
            out.append(delim.join(parts))
        return out

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        records = [split_line(l, self.config.field_delim_regex())
                   for l in read_lines(in_path)]
        out = self.classify_records(records, counters)
        write_output(out_path, out)
        return counters


# ---------------------------------------------------------------------------
# HMM builder
# ---------------------------------------------------------------------------

class HiddenMarkovModelBuilder:
    """Builds A / B / pi from tagged sequences; the model text format of
    HiddenMarkovModelBuilder.java:309-343."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        sub_delim = cfg.get("sub.field.delim", ":")
        skip = cfg.get_int("skip.field.count", 0)
        states = cfg.must("model.states").split(",")
        observations = cfg.must("model.observations").split(",")
        scale = cfg.get_int("trans.prob.scale", 1000)
        partially = cfg.get_boolean("partially.tagged", False)
        s_vocab = {s: i for i, s in enumerate(states)}
        o_vocab = {o: i for i, o in enumerate(observations)}
        S, O = len(states), len(observations)

        records = [split_line(l, delim_regex) for l in read_lines(in_path)]
        if partially:
            trans_c, obs_c, init_c = self._count_partially_tagged(
                records, states, s_vocab, o_vocab, cfg)
        else:
            trans_c, obs_c, init_c = self._count_fully_tagged(
                records, skip, sub_delim, s_vocab, o_vocab, S, O, mesh)

        lines: List[str] = [",".join(states), ",".join(observations)]
        lines.extend(serialize_matrix(normalize_rows(trans_c, scale)))
        lines.extend(serialize_matrix(normalize_rows(obs_c, scale)))
        # the initial vector keeps the reference's default scale of 100
        lines.extend(serialize_matrix(normalize_rows(init_c[None, :], 100)))
        write_output(out_path, lines)
        counters.set("HMM", "Transitions", int(trans_c.sum()))
        counters.set("HMM", "Emissions", int(obs_c.sum()))
        return counters

    def _count_fully_tagged(self, records, skip, sub_delim, s_vocab, o_vocab,
                            S, O, mesh):
        """Device path: encode the (state, obs) streams, count the three
        families."""
        st_rows, ob_rows = [], []
        for r in records:
            if len(r) < skip + 2:
                st_rows.append([]); ob_rows.append([])
                continue
            st, ob = [], []
            for item in r[skip:]:
                o, s = item.split(sub_delim)
                st.append(s); ob.append(o)
            st_rows.append(st); ob_rows.append(ob)
        st_seq, _ = encode_sequences(st_rows, 0, s_vocab)
        ob_seq, _ = encode_sequences(ob_rows, 0, o_vocab)
        frm, to = st_seq[:, :-1], st_seq[:, 1:]
        init = st_seq[:, 0] if st_seq.shape[1] else np.zeros(0, np.int32)
        res = _count(_hmm_local, frm, to, st_seq, ob_seq, init,
                     device=self.device, mesh=mesh, static_args=(S, O))
        return res["trans"], res["obs"], res["init"]

    def _count_partially_tagged(self, records, states, s_vocab, o_vocab, cfg):
        """Host path: the distance-decay window logic of
        HiddenMarkovModelBuilder.java:174-260 (including its asymmetric
        window arithmetic) is inherently per-row sequential; rows are few in
        this mode and counting stays exact on host."""
        window = [int(v) for v in cfg.must("window.function").split(",")]
        S, O = len(s_vocab), len(o_vocab)
        trans_c = np.zeros((S, S), dtype=np.int64)
        obs_c = np.zeros((S, O), dtype=np.int64)
        init_c = np.zeros(S, dtype=np.int64)
        state_set = set(states)
        for items in records:
            sidx = [i for i, it in enumerate(items) if it in state_set]
            if not sidx:
                continue
            init_c[s_vocab[items[sidx[0]]]] += 1
            for i, si in enumerate(sidx):
                # reference operator-precedence quirks preserved:
                # left = s[i] - s[i-1]/2 ; right = s[i+1] - s[i]/2
                if i > 0:
                    lw = sidx[i] - sidx[i - 1] // 2
                    lb = sidx[i] - lw
                else:
                    lb = -1
                if i < len(sidx) - 1:
                    rw = sidx[i + 1] - sidx[i] // 2
                    rb = sidx[i] + rw
                else:
                    rb = -1
                if lb == -1 and rb != -1:
                    lb = max(sidx[i] - rw, 0)
                elif rb == -1 and lb != -1:
                    rb = min(sidx[i] + lw, len(items) - 1)
                elif lb == -1 and rb == -1:
                    lb = sidx[i] // 2
                    rb = sidx[i] + (len(items) - 1 - sidx[i]) // 2
                s = s_vocab[items[si]]
                for j, k in zip(range(si - 1, lb - 1, -1), range(10 ** 9)):
                    if items[j] in o_vocab:
                        w = window[k] if k < len(window) else window[-1]
                        obs_c[s, o_vocab[items[j]]] += w
                for j, k in zip(range(si + 1, rb + 1), range(10 ** 9)):
                    if items[j] in o_vocab:
                        w = window[k] if k < len(window) else window[-1]
                        obs_c[s, o_vocab[items[j]]] += w
            for a, b in zip(sidx[:-1], sidx[1:]):
                trans_c[s_vocab[items[a]], s_vocab[items[b]]] += 1
        return trans_c, obs_c, init_c


# ---------------------------------------------------------------------------
# HMM model + Viterbi
# ---------------------------------------------------------------------------

class HiddenMarkovModel:
    """Text-format HMM loader (markov/HiddenMarkovModel.java:46-70)."""

    def __init__(self, lines: List[str]):
        self.states = lines[0].split(",")
        self.observations = lines[1].split(",")
        S, O = len(self.states), len(self.observations)
        self.trans = deserialize_matrix(lines[2:2 + S], S)
        self.obs = deserialize_matrix(lines[2 + S:2 + 2 * S], S)
        self.initial = np.asarray([float(v) for v in lines[2 + 2 * S].split(",")])
        self.obs_index = {o: i for i, o in enumerate(self.observations)}

    @classmethod
    def load(cls, path: str) -> "HiddenMarkovModel":
        return cls(list(read_lines(path)))


def viterbi_batch(obs_idx: torch.Tensor, lengths: torch.Tensor,
                  ltrans: torch.Tensor, lemit: torch.Tensor,
                  linit: torch.Tensor) -> torch.Tensor:
    """Batched max-product Viterbi in log space over ``[n, S]`` path
    scores, the whole row batch at once (the reference's ``lax.scan``).

    ``ltrans``, ``lemit`` and ``linit`` are the model's log tables
    (``host_log``: the reference's ``jnp.log`` bits).  Padded steps (obs
    == -1 at t >= length) freeze the path scores.  Each step's best
    predecessor is ``torch.argmax`` over ``[n, S, S]`` candidates, which
    returns the first maximum, as ``jnp.argmax`` does and as the
    reference's strict ``>`` keeps the lowest index.  Returns decoded
    state ids ``[n, T]`` (int64, forward order), -1 on padding."""
    n, T = obs_idx.shape
    if T == 0:
        return torch.empty((n, 0), dtype=torch.int64, device=obs_idx.device)
    obs_safe = torch.where(obs_idx >= 0, obs_idx, 0).to(torch.int64)
    lengths = lengths.to(torch.int64)
    path = linit[None, :] + lemit[:, obs_safe[:, 0]].t()          # [n, S]
    ptrs = [None] * T
    for t in range(1, T):
        active = (t < lengths)[:, None]
        cand = path[:, :, None] + ltrans[None, :, :]              # [n, S, S]
        best_p = torch.argmax(cand, dim=1)
        best = torch.amax(cand, dim=1)
        new_path = best + lemit[:, obs_safe[:, t]].t()
        path = torch.where(active, new_path, path)
        ptrs[t] = best_p

    nxt = torch.argmax(path, dim=1)                               # [n]
    out = torch.full((n, T), -1, dtype=torch.int64, device=obs_idx.device)
    for tt in range(T - 1, -1, -1):
        use = tt < lengths
        out[:, tt] = torch.where(use, nxt, -1)
        if tt > 0:
            prev = ptrs[tt].gather(1, nxt[:, None])[:, 0]
            nxt = torch.where(use, prev, nxt)
    return out


class ViterbiStatePredictor:
    """Map-only decoding job (ViterbiStatePredictor.java:77-152)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        delim = cfg.field_delim_out()
        skip = cfg.get_int("skip.field.count", 1)
        id_ord = cfg.get_int("id.field.ordinal", 0)
        state_only = cfg.get_boolean("output.state.only", True)
        sub_delim = cfg.get("sub.field.delim", ":")
        model = HiddenMarkovModel.load(cfg.must("hmm.model.path"))

        records = [split_line(l, delim_regex) for l in read_lines(in_path)]
        obs_idx, lengths = encode_sequences(records, skip, model.obs_index)
        dev = self.device
        decoded = viterbi_batch(
            torch.from_numpy(obs_idx).to(dev),
            torch.from_numpy(lengths).to(dev),
            *(torch.from_numpy(host_log(t)).to(dev)
              for t in (model.trans, model.obs, model.initial))
        ).cpu().numpy()

        out: List[str] = []
        for i, r in enumerate(records):
            L = int(lengths[i])
            parts = [r[id_ord]]
            for t in range(L):
                s = model.states[int(decoded[i, t])]
                if state_only:
                    parts.append(s)
                else:
                    parts.append(f"{r[skip + t]}{sub_delim}{s}")
            out.append(delim.join(parts))
            counters.incr("Viterbi", "Decoded")
        write_output(out_path, out)
        return counters
