"""Text analytics: analyzed word count.

Reference surface (citations into the Java avenir sources):
- ``org.avenir.text.WordCounter`` — mapper tokenizes the configured text
  column (``text.field.ordinal``; ordinal <= 0 means the whole line —
  text/WordCounter.java:98-103) with Lucene's ``StandardAnalyzer``
  (lowercasing + English stop-word removal, no stemming;
  text/WordCounter.java:94,117-128), emits ``(token, 1)``; reducer counts and
  writes ``word,count`` lines (:139-151).  The same analyzer backs
  BayesianDistribution's text mode.

The port's counterpart of ``avenir_tpu/models/text.py``.  The tokenizer
is jax-free host code and is copied as it is; ``WordCounter`` assigns
token ids on the host and counts them with one int64 ``count_table`` on
the job's device (or summed over a mesh, ``sharded_reduce(mesh=)``): the
reference counts in int64 under x64, which its command line turns on.
"""

from __future__ import annotations

import unicodedata
from typing import List

import numpy as np
import torch

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.obs import traced_run
from ..device import resolve_device
from ..ops.counting import count_table, sharded_reduce

# Lucene StandardAnalyzer's default English stop set (StopAnalyzer
# ENGLISH_STOP_WORDS_SET, the list StandardAnalyzer(Version.LUCENE_35) uses)
LUCENE_STOP_WORDS = frozenset("""
a an and are as at be but by for if in into is it no not of on or such that
the their then there these they this to was will with
""".split())

# ---------------------------------------------------------------------------
# UAX#29 word-break scanner, matching Lucene 3.5's StandardTokenizer
# (a JFlex grammar generated from the Unicode 6.0 word-break property
# data — text/WordCounter.java:117-128 builds StandardAnalyzer
# (Version.LUCENE_35)).  Rules implemented, with the Unicode-6.0 class
# memberships of that era:
#   WB5   ALetter x ALetter                     ("foo" + "bar")
#   WB6/7 ALetter x (MidLetter|MidNumLet) ALetter   ("don't", "a:b",
#         "john.smith" — colon was MidLetter in Unicode 6.0)
#   WB8   Numeric x Numeric
#   WB9/10 ALetter <-> Numeric                  ("x86", "3rd")
#   WB11/12 Numeric x (MidNum|MidNumLet) Numeric    ("3.14", "1,000")
#   WB13a/b ExtendNumLet ("_") joins words/numbers  ("foo_bar")
# plus Lucene's maxTokenLength (255): an over-long token is DISCARDED,
# not truncated (StandardTokenizer.incrementToken skips it and bumps
# the position increment).  Han/Hiragana ideographs emit one token per
# character and Katakana as runs, as the UAX29 grammar's IDEOGRAPHIC /
# HIRAGANA / KATAKANA productions do.

MAX_TOKEN_LENGTH = 255

# Unicode 6.0 Word_Break memberships (WordBreakProperty-6.0.0), the
# era Lucene 3.5's JFlex grammar was generated from (colon/semicolon
# were reclassified out of MidLetter/MidNum only in Unicode 6.3)
_MIDLETTER = frozenset("\u003A\u00B7\u0387\u05F4\u2027\uFE13\uFE55\uFF1A")
_MIDNUMLET = frozenset("\u0027\u002E\u2018\u2019\u2024\uFE52\uFF07\uFF0E")
_MIDNUM = frozenset("\u002C\u003B\u037E\u0589\u060C\u060D\u066C\u07F8\u2044\uFE10\uFE14\uFE50\uFE54\uFF0C\uFF1B")
_EXTEND = frozenset("\u005F\u203F\u2040\u2054\uFE33\uFE34\uFE4D\uFE4E\uFE4F\uFF3F")

# Katakana / Hiragana Word_Break memberships (WordBreakProperty-6.0.0);
# U+30FB KATAKANA MIDDLE DOT is Word_Break=Other — it SEPARATES
# katakana words — and the voiced-sound marks U+309B/309C are Katakana
_KATAKANA_RANGES = ((0x3031, 0x3035), (0x309B, 0x309C), (0x30A0, 0x30FA),
                    (0x30FC, 0x30FF), (0x31F0, 0x31FF), (0xFF66, 0xFF9F))
_HIRAGANA_RANGES = ((0x3041, 0x3096), (0x309D, 0x309F))


def _char_class(ch: str) -> str:
    """UAX#29 word-break class of one char (the subset the grammar
    distinguishes): A(Letter) N(umeric) ML MN MNL E(xtendNumLet)
    K(atakana) I(deographic incl. hiragana) or '' (break)."""
    if "a" <= ch <= "z" or "A" <= ch <= "Z":
        return "A"
    if "0" <= ch <= "9":
        return "N"
    if ch in _EXTEND:
        return "E"
    if ch in _MIDNUMLET:
        return "MNL"
    if ch in _MIDLETTER:
        return "ML"
    if ch in _MIDNUM:
        return "MN"
    o = ord(ch)
    if o < 128:
        return ""
    if any(lo <= o <= hi for lo, hi in _KATAKANA_RANGES):
        return "K"
    if any(lo <= o <= hi for lo, hi in _HIRAGANA_RANGES):
        return "I"
    cat = unicodedata.category(ch)
    if cat == "Nd":
        return "N"
    if cat.startswith("L"):
        # Han (and other ideographic letters) break per character
        if "CJK" in unicodedata.name(ch, ""):
            return "I"
        return "A"
    return ""


def _scan_word(cls, i: int, n: int) -> int:
    """End index of the word starting at alnum position ``i``: WB5/8/9/10
    runs, WB6/7 and WB11/12 single-mid joins, WB13a ExtendNumLet."""
    last_alnum = cls[i]
    i += 1
    while i < n:
        c = cls[i]
        if c in ("A", "N"):
            last_alnum = c
            i += 1
        elif c == "E":
            i += 1                             # WB13a: ExtendNumLet joins
        elif (last_alnum == "A" and c in ("ML", "MNL")
              and i + 1 < n and cls[i + 1] == "A"):
            last_alnum = "A"
            i += 2                             # WB6/7
        elif (last_alnum == "N" and c in ("MN", "MNL")
              and i + 1 < n and cls[i + 1] == "N"):
            last_alnum = "N"
            i += 2                             # WB11/12
        else:
            break
    return i


def _uax29_words(text: str) -> List[str]:
    """Maximal word tokens per the rules above (untruncated; the caller
    applies the maxTokenLength discard)."""
    out = []
    n = len(text)
    cls = [_char_class(c) for c in text]
    i = 0
    while i < n:
        c = cls[i]
        if c in ("A", "N"):
            end = _scan_word(cls, i, n)
            out.append(text[i:end])
            i = end
        elif c == "E":
            # leading underscores attach to a following word (WB13b);
            # bare underscores with no adjacent alnum are not words
            start = i
            while i < n and cls[i] == "E":
                i += 1
            if i < n and cls[i] in ("A", "N"):
                end = _scan_word(cls, i, n)
                out.append(text[start:end])
                i = end
        elif c == "K":
            start = i
            while i < n and cls[i] == "K":
                i += 1                         # WB13: Katakana runs
            out.append(text[start:i])
        elif c == "I":
            out.append(text[i])                # one token per ideograph
            i += 1
        else:
            i += 1
    return out


def standard_tokenize(text: str) -> List[str]:
    """StandardAnalyzer(Version.LUCENE_35)-equivalent: UAX#29 word
    tokens (Unicode-6.0 class memberships), tokens longer than 255
    chars discarded, lowercased, minus the English stop words (no
    stemming — the reference's ``tokenize`` comment says stemming but
    StandardAnalyzer does none).  Pinned by the golden fixture in
    the reference's tests/test_text.py::test_standard_tokenize_lucene_golden."""
    return [t for t in (w.lower() for w in _uax29_words(text)
                        if len(w) <= MAX_TOKEN_LENGTH)
            if t not in LUCENE_STOP_WORDS]


class WordCounter:
    """Analyzed word-count job."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    @traced_run
    def run(self, in_path: str, out_path: str, mesh=None) -> Counters:
        counters = Counters()
        cfg = self.config
        delim = cfg.field_delim_out()
        text_ord = cfg.must_int("text.field.ordinal")
        delim_regex = cfg.field_delim_regex()

        vocab: dict = {}
        ids: List[int] = []
        for line in read_lines(in_path):
            if text_ord > 0:
                text = split_line(line, delim_regex)[text_ord]
            else:
                text = line
            for token in standard_tokenize(text):
                ids.append(vocab.setdefault(token, len(vocab)))
        words = list(vocab)
        counters.set("Words", "Distinct", len(words))
        counters.set("Words", "Total", len(ids))

        if not words:
            write_output(out_path, [])
            return counters

        # the count: one int64 count_table on the device, or per mesh
        # position and summed (mapper + combiner, then the reducer's sum)
        id_arr = np.asarray(ids, dtype=np.int32)
        kw = {"mesh": mesh} if mesh is not None else {"device": self.device}
        counts = sharded_reduce(_wc_local, id_arr, static_args=(len(words),),
                                **kw).cpu().numpy()

        out = [f"{w}{delim}{int(counts[i])}" for i, w in enumerate(words)]
        write_output(out_path, out)
        return counters


def _wc_local(ids, mask, n_words):
    # int64: a token can pass 2^31 occurrences in a large corpus
    return count_table((n_words,), (ids,), mask=mask, dtype=torch.int64)
