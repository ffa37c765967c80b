"""Association mining: Apriori frequent itemsets, rule miner, marker.

The port's counterpart of ``avenir_tpu/models/association.py``, with the
same config keys (prefixes ``fia``, ``arm``, ``iim``), input layouts and
output bytes:

- ``FrequentItemsApriori``: one pass per itemset length k.  k = 1 counts
  tokens on the host; k > 1 counts the support of every candidate
  ``s ∪ {x}`` (s a frequent (k-1)-itemset, x an item) on the device as one
  product ``co = vᵀ · inc``, where ``inc[t, item]`` is the 0/1 incidence of
  the transactions over the items that can still reach the threshold and
  ``v[t, s] = Π_{i in s} inc[t, i]`` marks the transactions that hold s.
  In count mode a candidate reached from m frequent (k-1)-subsets is
  emitted m times per supporting transaction, as the reference does.
- ``ItemSetList``: the text loader of itemset lines.
- ``AssociationRuleMiner``: rules ``a1,a2 -> c1,c2`` above a confidence
  threshold (host).
- ``InfrequentItemMarker``: transactions with the infrequent items masked
  (host).

The host half (the bulk NumPy encode of the transaction file, cached per
input across the k passes; the pass-1 counts; the thresholding and line
emission) is a copy of the reference's.  The device half is written anew:

- The product runs in float32 with TF32 off, so every product of 0/1
  operands is exact and the float32 accumulation is exact below 2^24
  supporting rows.  (The reference feeds the MXU bf16 operands with
  float32 accumulation; ``torch.matmul`` of bf16 tensors returns bf16,
  which cannot hold such counts.)  The product lies outside any Pallas
  kernel in the reference, so it is a ``torch.matmul`` here.
- The candidate axis is cut into chunks of ``S`` candidates so that the
  ``[nt, S]`` indicator stays under 2^28 float32 elements (1 GB) a shard.
- The incidence is kept on the device across the k passes, as ``uint8``
  (keyed by the encode, the mode, the pruned vocabulary and the mesh,
  through a weak reference to the encode, at most two resident), and
  widened to float32 once per pass.
- ``mesh=``: the incidence rows shard over the mesh's ``data`` axis and
  the shards' products are summed by ``parallel.mesh.psum``.
- ``pipeline.chunk.rows``: the incidence streams through
  ``core.pipeline.streaming_fold`` in row chunks with the candidate index
  as a broadcast argument, on the job's device or with each chunk's rows
  sharded over every position of the mesh.
"""

from __future__ import annotations

import os
import weakref
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.obs import traced_run
from ..device import resolve_device
from ..utils.caches import bounded_cache_get, bounded_cache_put

# the [nt, S] indicator block's bound, in elements a shard
_INDICATOR_ELEMS = 1 << 28


def _fmt_support(v: float) -> str:
    """Utility.formatDouble(support, 3) equivalent."""
    return f"{v:.3f}"


class ItemSet:
    """(items, transactionIds) pair (association/ItemSetList.java:65-101)."""

    def __init__(self, items: Sequence[str], trans_ids: Sequence[str] = ()):
        self.items = list(items)
        self.transaction_ids = list(trans_ids)

    def contains_item(self, item: str) -> bool:
        return item in self.items

    def contains_trans(self, trans_id: str) -> bool:
        return trans_id in self.transaction_ids


class ItemSetList:
    """Loader for itemset output lines: items, [transIds,] support."""

    def __init__(self, path: str, item_set_length: int,
                 contains_trans_ids: bool, delim: str = ","):
        self.item_sets: List[ItemSet] = []
        for line in read_lines(path):
            tokens = line.split(delim)
            items = tokens[:item_set_length]
            tids = tokens[item_set_length:-1] if contains_trans_ids else ()
            self.item_sets.append(ItemSet(items, tids))

    def get_item_set_list(self) -> List[ItemSet]:
        return self.item_sets


def _support_products(incf: torch.Tensor, sets_idx: torch.Tensor
                      ) -> torch.Tensor:
    """``[C * S, V]`` float32 candidate supports of one row block:
    ``incf`` is its 0/1 float32 incidence ``[nt, V]`` (masked rows zero),
    ``sets_idx`` the ``[C, S, k-1]`` int64 column ids of the candidates'
    (k-1)-itemsets.  Per chunk of S candidates the indicator
    ``v = Π inc[:, cols]`` (``[nt, S]``) meets the incidence in one float32
    product with float32 accumulation, exact below 2^24 rows."""
    from ..ops.distance import _assert_no_tf32

    _assert_no_tf32(incf.device, "the Apriori support product")
    cos = []
    for idx_chunk in sets_idx:                      # [S, k-1]
        v = incf.index_select(1, idx_chunk[:, 0])   # [nt, S]
        for i in range(1, idx_chunk.shape[1]):
            v = v * incf.index_select(1, idx_chunk[:, i])
        cos.append(torch.matmul(v.t(), incf))       # [S, V]
    return torch.cat(cos)


def _widen(inc: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    incf = inc.to(torch.float32)
    if mask is not None:
        incf *= mask.to(torch.float32)[:, None]
    return incf


def _apriori_chunk_support_local(inc, mask, sets_idx, out=None):
    """Streaming-fold form of ``_apriori_support_local``: one incidence
    ROW CHUNK's contribution to the candidate-support matrix, added into
    the carry ``out`` (``core.pipeline``'s in-place accumulate).  Float32
    sums of 0/1 products are exact below 2^24 rows, so the folded counts
    equal the one-shot product's."""
    co = _support_products(_widen(inc, mask), sets_idx)
    if out is None:
        return co
    out += co
    return out


def _apriori_support_local(inc, sets_idx, mask):
    """One shard's candidate supports: ``inc`` its ``[nt, V]`` uint8
    incidence rows, ``sets_idx`` the ``[C, S, k-1]`` candidate chunks,
    ``mask`` its row validity (False on padding)."""
    return _support_products(_widen(inc, mask), sets_idx)


def _mesh_key(mesh) -> tuple:
    return (mesh.devices.shape, tuple(mesh.devices.flat))


# Row-sharded incidence matrices kept on the device across k passes (keyed
# by the encode's identity, the mode, the pruned vocabulary and the mesh).
_inc_device_cache: Dict = {}


class _EncodedTransactions:
    """Bulk-parsed transaction file: flat (row, item-id) token streams,
    sorted vocabulary, and pass-1 counts, computed once and shared by every
    k pass over the same input."""

    def __init__(self, in_path: str, delim_regex: str, skip: int,
                 trans_ord: int, marker: Optional[str]):
        records = [split_line(l, delim_regex) for l in read_lines(in_path)]
        self.nt = len(records)
        # transaction IDENTITY is the id string, not the input line: the
        # reference reducer unions trans-id strings, so a transaction split
        # across lines counts once in distinct mode
        # (FrequentItemsApriori.java:311-326).  tid_vocab is sorted by
        # np.unique, matching the sorted tid emission.
        trans_id_strs = [r[trans_ord] for r in records]
        self.tid_vocab, tid_codes = np.unique(
            np.asarray(trans_id_strs, dtype=object).astype(str),
            return_inverse=True)
        self.n_tid = len(self.tid_vocab)
        lengths = np.asarray([max(len(r) - skip, 0) for r in records],
                             dtype=np.int64)
        rows = np.repeat(np.arange(self.nt, dtype=np.int64), lengths)
        tokens = np.asarray([it for r in records for it in r[skip:]],
                            dtype=object)
        if marker is not None:
            keep = tokens != marker
            rows, tokens = rows[keep], tokens[keep]
        # np.unique sorts -> vocab order == the reference's sorted emission
        self.vocab, ids = np.unique(tokens.astype(str), return_inverse=True)
        self.ids = ids.astype(np.int64)
        self.rows = rows
        V = len(self.vocab)
        self.occ_counts = np.bincount(self.ids, minlength=V)
        # count mode counts supporting input ROWS: dedupe (row, item)
        rpair = np.unique(self.rows * V + self.ids)
        self.drows = (rpair // V).astype(np.int64)
        self.dids = (rpair % V).astype(np.int64)
        # distinct mode counts distinct TRANSACTION IDS: dedupe (tid, item)
        tcodes = tid_codes.astype(np.int64)[self.rows]
        tpair = np.unique(tcodes * V + self.ids)
        self.dtids = (tpair // V).astype(np.int64)
        self.dtids_item = (tpair % V).astype(np.int64)
        self.distinct_counts = np.bincount(self.dtids_item, minlength=V)
        # (item-major ordering of the (tid, item) pairs, for tid lists)
        order = np.argsort(self.dtids_item, kind="stable")
        self._items_sorted = self.dtids_item[order]
        self._tids_by_item = self.dtids[order]
        self._item_starts = np.searchsorted(
            self._items_sorted, np.arange(V + 1))
        self.vocab_index = {it: i for i, it in enumerate(self.vocab)}

    def tid_codes_for_item(self, item_id: int) -> np.ndarray:
        """Codes (into tid_vocab) of the distinct transactions containing
        the item, in sorted-tid order."""
        s, e = self._item_starts[item_id], self._item_starts[item_id + 1]
        return np.sort(self._tids_by_item[s:e])


_encode_cache: Dict = {}


def _encode_transactions(in_path: str, delim_regex: str, skip: int,
                         trans_ord: int,
                         marker: Optional[str]) -> _EncodedTransactions:
    if os.path.isdir(in_path):
        # a job-output directory of part files: stamp each member (a part
        # file rewritten in place changes its own mtime, not the dir's)
        stamp = tuple(sorted(
            (f, os.stat(os.path.join(in_path, f)).st_mtime_ns,
             os.stat(os.path.join(in_path, f)).st_size)
            for f in os.listdir(in_path)))
    else:
        st = os.stat(in_path)
        stamp = (st.st_mtime_ns, st.st_size)
    key = (os.path.abspath(in_path), stamp, delim_regex, skip, trans_ord,
           marker)
    enc = bounded_cache_get(_encode_cache, key)
    if enc is None:
        enc = _EncodedTransactions(in_path, delim_regex, skip, trans_ord,
                                   marker)
        bounded_cache_put(_encode_cache, key, enc)
    return enc


class FrequentItemsApriori:
    """One Apriori pass (one k); config prefix ``fia``.  The support
    product runs on ``device`` (``cuda:0`` unless the caller asks for the
    CPU), or on the mesh passed to ``run``."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config.with_prefix("fia") if not config.prefix else config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        delim = cfg.field_delim_out()
        skip = cfg.get_int("skip.field.count", 1)
        k = cfg.must_int("item.set.length", "missing item set length")
        trans_ord = cfg.must_int("tans.id.ord", "missing transaction id ordinal")
        emit_trans_id = cfg.get_boolean("emit.trans.id", True)
        threshold = cfg.must_float("support.threshold", "missing support threshold")
        total_trans = cfg.must_int("total.tans.count", "missing total transaction count")
        trans_id_output = cfg.get_boolean("trans.id.output", True)
        marker = cfg.get("infreq.item.marker")

        enc = _encode_transactions(in_path, delim_regex, skip, trans_ord,
                                   marker)
        if k == 1:
            lines = self._pass_one(enc, emit_trans_id, threshold, total_trans,
                                   trans_id_output, delim)
        else:
            prev = ItemSetList(cfg.must("item.set.file.path"), k - 1,
                               emit_trans_id, ",")
            lines = self._pass_k(enc, prev, k, emit_trans_id, threshold,
                                 total_trans, trans_id_output, delim, mesh)
        write_output(out_path, lines)
        counters.set("Apriori", "FrequentItemSets", len(lines))
        return counters

    # -- k == 1: vectorized token counting ---------------------------------
    def _pass_one(self, enc: _EncodedTransactions, emit_trans_id, threshold,
                  total_trans, trans_id_output, delim) -> List[str]:
        # the reference counts every token occurrence at k=1 in count mode,
        # distinct transactions in trans-id mode
        counts = enc.distinct_counts if emit_trans_id else enc.occ_counts
        support = counts / total_trans
        frequent = np.nonzero(support > threshold)[0]
        lines = []
        for i in frequent:          # vocab is sorted; emission order matches
            it = enc.vocab[i]
            if emit_trans_id:
                if trans_id_output:
                    tids = list(enc.tid_vocab[enc.tid_codes_for_item(i)])
                    lines.append(delim.join([it] + tids +
                                            [_fmt_support(support[i])]))
                else:
                    lines.append(f"{it}{delim}{_fmt_support(support[i])}")
            else:
                lines.append(f"{it}{delim}{counts[i]}{delim}"
                             f"{_fmt_support(support[i])}")
        return lines

    # -- k > 1: the incidence product on the device -------------------------
    def _pass_k(self, enc: _EncodedTransactions, prev: ItemSetList, k,
                emit_trans_id, threshold, total_trans, trans_id_output,
                delim, mesh) -> List[str]:
        from ..parallel.mesh import make_mesh, psum, replicate

        mesh = mesh or make_mesh([self.device])
        V = len(enc.vocab)
        vocab_index = enc.vocab_index
        prev_sets = [s for s in prev.get_item_set_list()
                     if all(it in vocab_index for it in s.items)]
        if not prev_sets:
            return []

        # prune the extension vocabulary to items that can still reach the
        # threshold (support is monotone: support(s ∪ {x}) <= support({x})).
        # Emission is strict >, so the bound is strict too.  Count mode
        # emits distinct x multiplicity with multiplicity <= k.
        counts1 = enc.distinct_counts if emit_trans_id else enc.occ_counts
        bound = threshold * total_trans / (1 if emit_trans_id else k)
        keep = counts1 > bound
        # previous-itemset members are above the bound already (their
        # (k-1)-set passed the threshold); include them defensively
        sets_idx_full = np.asarray(
            [[vocab_index[it] for it in s.items] for s in prev_sets],
            dtype=np.int64)                            # [n_s, k-1]
        keep[sets_idx_full.ravel()] = True
        kept = np.nonzero(keep)[0]
        col_of = np.full(V, -1, dtype=np.int64)
        col_of[kept] = np.arange(len(kept))
        V_eff = len(kept)

        # incidence over the pruned vocabulary, built by one bulk scatter.
        # Distinct mode counts distinct TRANSACTION IDS (one incidence row
        # per tid, so a transaction split across input lines counts once);
        # count mode counts supporting input ROWS.
        if emit_trans_id:
            prows, pitems = enc.dtids, enc.dtids_item
            n_rows = enc.n_tid
        else:
            prows, pitems = enc.drows, enc.dids
            n_rows = enc.nt
        sel = col_of[pitems] >= 0

        def build_inc():
            m = np.zeros((n_rows, V_eff), dtype=np.uint8)
            m[prows[sel], col_of[pitems[sel]]] = 1
            return m

        sets_idx = col_of[sets_idx_full].astype(np.int32)
        n_s = sets_idx.shape[0]

        # out-of-core support counting (pipeline.chunk.rows /
        # pipeline.device.budget.bytes): incidence rows stream through
        # core.pipeline in bounded chunks instead of one resident array
        chunk_rows = self.config.pipeline_chunk_rows(
            row_bytes=max(V_eff, 1))
        if chunk_rows is not None and chunk_rows < n_rows:
            def inc_chunk(start, stop, dtype=np.uint8):
                lo, hi = np.searchsorted(prows, [start, stop])
                pr, pi = prows[lo:hi], pitems[lo:hi]
                s = sel[lo:hi]
                m = np.zeros((stop - start, V_eff), dtype=dtype)
                m[pr[s] - start, col_of[pi[s]]] = 1
                return m

            co = self._support_streamed(
                inc_chunk, n_rows, V_eff, sets_idx, k, mesh, chunk_rows,
                self.config.pipeline_prefetch_depth())
            return self._emit_pass_k(
                enc, prev_sets, sets_idx, co, k, emit_trans_id, threshold,
                total_trans, trans_id_output, delim, col_of, kept, V_eff,
                vocab_index,
                tid_rows_fn=lambda cands: self._tid_rows_chunked(
                    inc_chunk, n_rows, chunk_rows, cands))

        inc = None
        inc_dev, mask_dev = self._resident_incidence(
            enc, emit_trans_id, mesh, kept)
        if inc_dev is None:
            inc = build_inc()
            inc_dev, mask_dev = self._place_incidence(
                enc, emit_trans_id, mesh, kept, inc)
        d = mesh.shape["data"]
        nt_local = max(-(-n_rows // d), 1)
        sets_p = self._candidate_chunks(sets_idx, nt_local, k)
        by_dev = dict(zip(mesh.devices.flat, replicate(sets_p, mesh)))
        outs = [_apriori_support_local(inc_s, by_dev[inc_s.device], m_s)
                for inc_s, m_s in zip(inc_dev, mask_dev)]
        co = psum(outs)[0].cpu().numpy()[:n_s]           # [n_s, V_eff]

        def tid_rows_full(cand_cols):
            inc_bool = (inc if inc is not None else build_inc()).astype(bool)
            return {cand: np.nonzero(inc_bool[:, cols].all(axis=1))[0]
                    for cand, cols in cand_cols.items()}

        return self._emit_pass_k(
            enc, prev_sets, sets_idx, co, k, emit_trans_id, threshold,
            total_trans, trans_id_output, delim, col_of, kept, V_eff,
            vocab_index, tid_rows_fn=tid_rows_full)

    @staticmethod
    def _cache_key(enc, emit_trans_id, mesh, kept) -> tuple:
        return (id(enc), emit_trans_id, _mesh_key(mesh), kept.tobytes())

    def _resident_incidence(self, enc, emit_trans_id, mesh, kept) -> tuple:
        """The row-sharded device incidence of an earlier pass over the
        same encode, mode, pruned vocabulary and mesh, or (None, None).
        The pruned vocabulary is k-invariant in distinct mode and usually
        so in count mode, so the host build and the copy happen once per
        input.  The entry holds the encode only weakly: an id reused
        after the encode was collected is a miss."""
        cached = bounded_cache_get(
            _inc_device_cache, self._cache_key(enc, emit_trans_id, mesh, kept))
        if cached is None or cached[0]() is not enc:
            return None, None
        return cached[1], cached[2]

    def _place_incidence(self, enc, emit_trans_id, mesh, kept, inc) -> tuple:
        """Shard ``inc`` (uint8) over the mesh's data axis and keep it for
        the next passes.  The weak reference's callback drops the entry
        when the encode cache lets the encode go, releasing the device
        memory with it."""
        from ..parallel.mesh import pad_rows, shard_rows

        ckey = self._cache_key(enc, emit_trans_id, mesh, kept)
        inc_p, mask = pad_rows(inc, mesh.shape["data"])
        inc_dev = shard_rows(inc_p, mesh)
        mask_dev = shard_rows(mask, mesh)
        ref = weakref.ref(enc, lambda _: _inc_device_cache.pop(ckey, None))
        bounded_cache_put(_inc_device_cache, ckey, (ref, inc_dev, mask_dev),
                          cap=2)
        return inc_dev, mask_dev

    @staticmethod
    def _candidate_chunks(sets_idx: np.ndarray, nt_local: int,
                          k: int) -> np.ndarray:
        """The candidates as ``[C, S, k-1]`` int64 chunks of
        ``S = max(min(n_s, 2^28 // nt_local), 16)`` (the last chunk padded
        with column 0; its rows are cut from the result)."""
        n_s = sets_idx.shape[0]
        S = max(min(n_s, _INDICATOR_ELEMS // max(nt_local, 1)), 16)
        C = -(-n_s // S)
        pad_s = C * S - n_s
        sets_p = sets_idx if not pad_s else np.concatenate(
            [sets_idx, np.zeros((pad_s, k - 1), np.int32)])
        return sets_p.reshape(C, S, k - 1).astype(np.int64)

    def _support_streamed(self, inc_chunk, n_rows, V_eff, sets_idx, k,
                          mesh, chunk_rows, depth):
        """Candidate supports by streaming incidence ROW chunks through
        ``core.pipeline``: chunk c+1's build and copy overlap chunk c's
        product, and only (depth + 2) chunks are ever resident.  On a mesh
        each chunk's rows shard over every position (each holds
        ``ceil(chunk_rows / d)`` of them, the candidates' chunk size) and
        the candidates are a broadcast argument, copied once to each
        device."""
        from ..core import pipeline

        n_s = sets_idx.shape[0]
        nt_loc = max(-(-min(chunk_rows, max(n_rows, 1)) // mesh.size), 1)

        def chunks():
            for start in range(0, n_rows, chunk_rows):
                yield (inc_chunk(start, min(start + chunk_rows, n_rows)),)

        # each position's product, the mesh's psum of them and the carry
        # are float32 sums of 0/1 products: exact integers below 2^24
        # rows, a shard's and the whole input's
        co = pipeline.streaming_fold(
            chunks(), _apriori_chunk_support_local,
            broadcast_args=(self._candidate_chunks(sets_idx, nt_loc, k),),
            mesh=mesh, prefetch_depth=depth)
        if co is None:
            return np.zeros((n_s, V_eff), dtype=np.float32)
        return co[:n_s]

    @staticmethod
    def _tid_rows_chunked(inc_chunk, n_rows, chunk_rows, cand_cols):
        """Per-candidate supporting row codes without materializing the
        full incidence: one more chunked host pass (ascending starts keep
        the sorted-tid emission order)."""
        out = {cand: [] for cand in cand_cols}
        for start in range(0, n_rows, chunk_rows):
            m = inc_chunk(start, min(start + chunk_rows, n_rows),
                          dtype=bool)
            for cand, cols in cand_cols.items():
                r = np.nonzero(m[:, cols].all(axis=1))[0]
                if r.size:
                    out[cand].append(r + start)
        return {cand: (np.concatenate(rs) if rs
                       else np.zeros(0, dtype=np.int64))
                for cand, rs in out.items()}

    def _emit_pass_k(self, enc, prev_sets, sets_idx, co, k, emit_trans_id,
                     threshold, total_trans, trans_id_output, delim,
                     col_of, kept, V_eff, vocab_index,
                     tid_rows_fn) -> List[str]:
        """Threshold + line emission shared by the resident and streamed
        support paths (the reference shuffles every candidate and filters
        in the reducer, FrequentItemsApriori.java:306-342 — same output).
        Thresholding happens BEFORE materializing candidates: only
        survivors get Python tuples."""
        cnt_mat = np.rint(co).astype(np.int64)
        member = np.zeros((len(prev_sets), V_eff), dtype=bool)
        member[np.arange(len(prev_sets))[:, None], sets_idx] = True
        if emit_trans_id:
            survive = (cnt_mat > threshold * total_trans) & ~member
        else:
            # multiplicity (#frequent (k-1)-subsets) is at most k
            survive = (cnt_mat * k > threshold * total_trans) & ~member \
                & (cnt_mat > 0)

        distinct: Dict[Tuple[str, ...], int] = {}
        prev_keys = {tuple(sorted(s.items)) for s in prev_sets}
        for si, x in zip(*np.nonzero(survive)):
            cand = tuple(sorted(prev_sets[si].items +
                                [enc.vocab[kept[x]]]))
            distinct[cand] = int(cnt_mat[si, x])

        lines = []
        tid_rows = None
        if emit_trans_id and trans_id_output and distinct:
            # incidence rows are tid codes; tid_vocab is sorted and row
            # codes ascend, so the emission order is sorted-tid order
            tid_rows = tid_rows_fn(
                {cand: [col_of[vocab_index[it]] for it in cand]
                 for cand in distinct})
        for cand in sorted(distinct):
            cnt = distinct[cand]
            if not emit_trans_id:
                m = sum(1 for sub in combinations(cand, k - 1)
                        if tuple(sorted(sub)) in prev_keys)
                cnt = cnt * m
            support = (distinct[cand] if emit_trans_id else cnt) / total_trans
            if support > threshold:
                if emit_trans_id:
                    if trans_id_output:
                        tids = list(enc.tid_vocab[tid_rows[cand]])
                        lines.append(delim.join(list(cand) + tids +
                                                [_fmt_support(support)]))
                    else:
                        lines.append(delim.join(list(cand) +
                                                [_fmt_support(support)]))
                else:
                    lines.append(delim.join(list(cand) +
                                            [str(cnt), _fmt_support(support)]))
        return lines


class AssociationRuleMiner:
    """Rules from frequent itemsets (+supports); config prefix ``arm``."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config.with_prefix("arm") if not config.prefix else config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        max_ante = cfg.get_int("max.ante.size", 3)
        conf_threshold = cfg.must_float("conf.threshold",
                                        "missing confidence threshold")

        supports: Dict[Tuple[str, ...], float] = {}
        itemsets: List[Tuple[Tuple[str, ...], float]] = []
        for line in read_lines(in_path):
            tokens = split_line(line, delim_regex)
            items = tuple(tokens[:-1])
            support = float(tokens[-1])
            supports[tuple(sorted(items))] = support
            itemsets.append((items, support))

        out = []
        for items, support in itemsets:
            if len(items) <= 1:
                continue
            for size in range(1, min(max_ante, len(items) - 1) + 1):
                for ante in combinations(items, size):
                    ante_support = supports.get(tuple(sorted(ante)))
                    if ante_support is None:
                        continue  # antecedent itself not frequent
                    confidence = support / ante_support
                    if confidence > conf_threshold:
                        cons = [it for it in items if it not in ante]
                        out.append(",".join(ante) + " -> " + ",".join(cons))
                        counters.incr("Rules", "Emitted")
        write_output(out_path, out)
        return counters


class InfrequentItemMarker:
    """Rewrite transactions, masking infrequent items; prefix ``iim``."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config.with_prefix("iim") if not config.prefix else config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim_regex = cfg.field_delim_regex()
        delim_out = cfg.field_delim_out()
        skip = cfg.get_int("skip.field.count", 1)
        length = cfg.must_int("item.set.length", "missing item set length")
        if length != 1:
            raise ValueError("expecting item set of length 1")
        contains_tid = cfg.get_boolean("contains.trans.id", True)
        marker = cfg.get("infreq.item.marker", "*")
        isl = ItemSetList(cfg.must("item.set.file.path"), 1, contains_tid,
                          cfg.get("itemset.delim", ","))
        freq = {s.items[0] for s in isl.get_item_set_list()}

        out = []
        for line in read_lines(in_path):
            items = split_line(line, delim_regex)
            for i in range(skip, len(items)):
                if items[i] not in freq:
                    items[i] = marker
                    counters.incr("Marker", "Masked")
            out.append(delim_out.join(items))
        write_output(out_path, out)
        return counters
