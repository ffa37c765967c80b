"""Probabilistic suffix tree: n-gram count generator + in-memory tree.

Reference surface:
- ``markov.ProbabilisticSuffixTreeGenerator`` — per record emits every
  sliding window of length 2..max.seq.length (optionally per partition-id
  fields and per class label), plus a root-symbol line whose count is the
  number of windows the record produced
  (ProbabilisticSuffixTreeGenerator.java:150-211); reducer sums and writes
  ``[partIds,][classLabel,]sym1,..,symk,count`` lines (:294-304).  A
  one-event-per-row input mode maintains a rolling window per partition
  (:219-243).
- ``markov.SuffixTreeBuilder`` / ``SuffixTreeNode`` — in-memory suffix tree
  built from those lines (SuffixTreeBuilder.java:45-70), used downstream for
  sequence probability queries; no job of the port reads it, and it is not
  ported.

The port's counterpart of ``avenir_tpu/models/pst.py``, with the same
config keys and output bytes.  Symbols are vocab-encoded on the host; in
sequential mode every row joins ONE stream (-1 between rows, a fused
partition/class id per token) whose windows of each length w are counted
by ``ops.counting.sharded_ngram_counts`` on the job's device, or on a mesh
with a halo from each position to the one before it.  Sessionized rows
(``input.format.sequential=false``) count the length-w prefix of each
rolling window with ``count_table`` (``_pst_local``).  When the dense key
space P x V^w would pass ``_DENSE_CAP`` cells the job counts on the host
instead (the ``PST / HostFallbackWindows`` counter) with the same output.
"""

from __future__ import annotations

from collections import Counter as PyCounter
from typing import Dict, List, Tuple

import numpy as np

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.obs import traced_run
from ..device import resolve_device
from ..ops.counting import (count_table, sharded_ngram_counts,
                            sharded_reduce)

_DENSE_CAP = 1 << 22  # max dense count-tensor cells before host fallback


def _pst_local(windows, part_cls, mask, sizes):
    """windows int32 [n, w]; part_cls int32 [n] combined partition/class id."""
    idx = tuple(part_cls[:, None] if d == 0 else windows[:, d - 1:d]
                for d in range(len(sizes)))
    m = None if mask is None else mask[:, None]
    return count_table(sizes, idx, mask=m)


class ProbabilisticSuffixTreeGenerator:
    """The PST counting job."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        delim = cfg.field_delim_out()
        skip = cfg.get_int("skip.field.count", 0)
        class_ord = cfg.get_int("class.label.field.ord", -1)
        if class_ord >= 0:
            skip += 1
        root_symbol = cfg.get("tree.root.symbol", "$")
        max_len = cfg.get_int("max.seq.length", 5)
        id_ords = cfg.get_list("id.field.ordinals")
        id_ords = [int(v) for v in id_ords] if id_ords else None
        sequential = cfg.get_boolean("input.format.sequential", True)
        where = {"mesh": mesh} if mesh is not None else {"device": self.device}

        records = [split_line(l, delim_regex) for l in read_lines(in_path)]
        if not sequential:
            data_ord = cfg.must_int(
                "data.field.ordinal",
                "for non sequential data data field ordinal must be specified")
            records = self._sessionize(records, id_ords, class_ord, data_ord,
                                       max_len)
            skip_eff = (len(id_ords) if id_ords else 0) + (1 if class_ord >= 0 else 0)
        else:
            skip_eff = skip

        # prefix = partition ids + class label (both optional)
        prefixes: List[Tuple[str, ...]] = []
        seqs: List[List[str]] = []
        vocab: Dict[str, int] = {}
        for r in records:
            if sequential:
                pre = tuple(r[o] for o in id_ords) if id_ords else ()
                if class_ord >= 0:
                    pre = pre + (r[class_ord],)
            else:
                pre = tuple(r[:skip_eff])
            body = r[skip_eff:]
            prefixes.append(pre)
            seqs.append(body)
            for s in body:
                if s not in vocab:
                    vocab[s] = len(vocab)

        pre_vocab: Dict[Tuple[str, ...], int] = {}
        for p in prefixes:
            if p not in pre_vocab:
                pre_vocab[p] = len(pre_vocab)

        V = max(1, len(vocab))
        P = max(1, len(pre_vocab))
        ngram_counts: Dict[Tuple, int] = {}
        root_counts: Dict[Tuple[str, ...], int] = PyCounter()

        inv = list(vocab.keys())
        inv_pre = list(pre_vocab.keys())

        def extract(c: np.ndarray) -> None:
            for key in np.argwhere(c > 0):
                toks_k = tuple(inv[k] for k in key[1:])
                ngram_counts[(inv_pre[key[0]],) + toks_k] = int(c[tuple(key)])

        # sequential mode: concatenate every row into ONE segmented stream
        # (-1 separators, per-token fused prefix id) so all sliding windows
        # of every length come from the halo-exchange window counter, with
        # no host window materialization
        # (ProbabilisticSuffixTreeGenerator.java:153-173); skipped when even
        # the w=2 table exceeds the dense cap (every w would fall back)
        stream = seg_ids = None
        if sequential and max_len >= 2 and P * V * V <= _DENSE_CAP:
            toks, sgs = [], []
            for r_i, body in enumerate(seqs):
                if len(body) < 2:
                    continue
                toks.extend(vocab[t] for t in body)
                toks.append(-1)
                sgs.extend([pre_vocab[prefixes[r_i]]] * len(body))
                sgs.append(-1)
            stream = np.asarray(toks, dtype=np.int32)
            seg_ids = np.asarray(sgs, dtype=np.int32)

        for w in range(2, max_len + 1):
            sizes = (P,) + (V,) * w
            if (stream is not None and stream.size
                    and int(np.prod(sizes)) <= _DENSE_CAP):
                c = sharded_ngram_counts(stream, V, w, seg=seg_ids, n_seg=P,
                                         **where).cpu().numpy()
                extract(c)
                for p_i in range(P):
                    n_win = int(c[p_i].sum())
                    if n_win:
                        root_counts[inv_pre[p_i]] += n_win
                continue
            # sessionized rows emit ONLY the length-w prefix of each full
            # rolling window — the reference emits window[0:w] once per
            # event (:225-241), so sliding inside overlapping windows would
            # over-count interior n-grams; also the host fallback for
            # over-cap dense tables
            rows, pcs = [], []
            for r_i, body in enumerate(seqs):
                if len(body) < 2:
                    continue
                if sequential:
                    starts = range(0, len(body) - w + 1)
                else:
                    starts = range(0, 1) if len(body) >= w else range(0)
                for s in starts:
                    rows.append([vocab[t] for t in body[s:s + w]])
                    pcs.append(pre_vocab[prefixes[r_i]])
                    root_counts[prefixes[r_i]] += 1
            if not rows:
                continue
            windows = np.asarray(rows, dtype=np.int32)
            part_cls = np.asarray(pcs, dtype=np.int32)
            if int(np.prod(sizes)) <= _DENSE_CAP:
                c = sharded_reduce(_pst_local, windows, part_cls,
                                   static_args=(sizes,),
                                   **where).cpu().numpy()
                extract(c)
            else:
                host = PyCounter()
                for row, pc in zip(rows, pcs):
                    host[(inv_pre[pc],) + tuple(inv[k] for k in row)] += 1
                for k, v in host.items():
                    ngram_counts[k] = ngram_counts.get(k, 0) + v
                counters.incr("PST", "HostFallbackWindows", len(rows))

        lines: List[str] = []
        for key in sorted(ngram_counts):
            pre, toks = key[0], key[1:]
            parts = list(pre) + list(toks) + [str(ngram_counts[key])]
            lines.append(delim.join(parts))
        for pre in sorted(root_counts):
            lines.append(delim.join(list(pre) + [root_symbol,
                                                 str(root_counts[pre])]))
        write_output(out_path, lines)
        counters.set("PST", "Ngrams", len(ngram_counts))
        return counters

    @staticmethod
    def _sessionize(records, id_ords, class_ord, data_ord, max_len):
        """One-event-per-row input: maintain a rolling window per partition
        and materialize one pseudo-record per full window
        (ProbabilisticSuffixTreeGenerator.java:219-243)."""
        windows: Dict[Tuple[str, ...], List[str]] = {}
        out = []
        for r in records:
            pid = tuple(r[o] for o in id_ords) if id_ords else ()
            key = pid + ((r[class_ord],) if class_ord >= 0 else ())
            win = windows.setdefault(key, [])
            win.append(r[data_ord])
            if len(win) > max_len:
                win.pop(0)
            if len(win) == max_len:
                out.append(list(key) + list(win))
        return out
